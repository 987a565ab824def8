"""Export a port checkpoint to the reference (MrRobot2211/miner) format.

The inverse of ``import_reference_checkpoint``: loads a port checkpoint
file (``<run>/ckpt/bestAucModel`` or ``finalModel``), maps its parameters
onto the reference's names
(``miner_tpu_torch.models.hf_import.export_*_state_dict``) and
``torch.save``s the state dict. The reference loads it with
``model.load_state_dict(torch.load(f), strict=False)`` (``strict=False``
regenerates the buffers it does not carry, e.g. ``position_ids``). The
flags are those of the JAX package's ``tools/export_to_reference.py``;
``--ckpt`` names a port checkpoint file, not an Orbax directory.

    python -m miner_tpu_torch.tools.export_to_reference \\
        --ckpt /path/to/run/ckpt/bestAucModel --plm_name roberta --out exported.pt
"""
from __future__ import annotations

import argparse
from typing import Dict

import torch

from miner_tpu_torch.models import hf_import
from miner_tpu_torch.training import checkpoint

MODELS = ("miner", "fastformer", "unbert", "unisrec")


def export(state: Dict[str, torch.Tensor], model_name: str, plm_name: str = "roberta",
           legacy_history_layout: bool = False) -> Dict[str, torch.Tensor]:
    """The reference-format state dict of the port's, fp32 and contiguous
    (UniSRec's history-layout marker kept in its int8)."""
    state = {k: v.detach().cpu() for k, v in state.items()}
    if model_name == "miner":
        sd = hf_import.export_miner_state_dict(state, plm_name=plm_name)
    elif model_name == "fastformer":
        sd = hf_import.export_fastformer_state_dict(state, plm_name=plm_name)
    elif model_name == "unbert":
        sd = hf_import.export_unbert_state_dict(state)
    else:
        sd = hf_import.export_unisrec_state_dict(
            state, plm_name=plm_name,
            history_layout="legacy" if legacy_history_layout else "clicks_first")
    return {k: v if k == hf_import.HISTORY_LAYOUT_MARKER else v.float().contiguous()
            for k, v in sd.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True, help="port checkpoint file written by the trainer")
    ap.add_argument("--plm_name", default="roberta", choices=["roberta", "bert"],
                    help="attribute name the reference NewsEncoder uses for the tower "
                         "(roberta for RoBERTa configs, bert for BERT ones)")
    ap.add_argument("--model_name", default="miner", choices=MODELS,
                    help="which reference model class to export for")
    ap.add_argument("--legacy_history_layout", action="store_true",
                    help="acknowledge the exported model was trained with "
                         "--legacy_history_layout (the reference's pads-first rows) — "
                         "required for the position-sensitive models")
    ap.add_argument("--force_layout_mismatch", action="store_true",
                    help="export a position-sensitive model anyway; in the reference it "
                         "will see pads-first rows it was not trained on")
    ap.add_argument("--out", required=True, help="output .pt path")
    args = ap.parse_args(argv)
    hf_import.check_history_layout_for_transfer(args.model_name, args.legacy_history_layout,
                                                force=args.force_layout_mismatch)
    sd = export(checkpoint.load(args.ckpt)["params"], args.model_name, args.plm_name,
                args.legacy_history_layout)
    torch.save(sd, args.out)
    print(f"wrote {len(sd)} tensors to {args.out}")


if __name__ == "__main__":
    main()

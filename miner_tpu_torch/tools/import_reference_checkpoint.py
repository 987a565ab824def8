"""Import a reference (MrRobot2211/miner) checkpoint into a port checkpoint.

The reference pickles whole ``nn.Module``s: ``torch.save({'model': <Miner>,
'optimizer': ..., 'scheduler': ...}, 'bestAucModel.pt')`` (reference:
src/base_trainer.py:204-221), so unpickling one needs the reference package
importable (``--reference_repo``). A bare ``state_dict`` file needs nothing.
Every tensor is mapped onto the port's module names
(``miner_tpu_torch.models.hf_import.convert_*_state_dict``), and the result
is written as a port checkpoint file that ``--saved_model_path`` (``eval``,
``serve``, ``recommend``) and ``--pretrained_model_path`` load. It carries
no optimizer state, so ``--resume_from`` refuses it. The flags are those of
the JAX package's ``tools/import_reference_checkpoint.py``; ``--out`` names
a file, not an Orbax directory.

    python -m miner_tpu_torch.tools.import_reference_checkpoint \\
        --torch_ckpt /path/to/bestAucModel.pt --reference_repo /path/to/reference \\
        --num_layers 12 --out converted/bestAucModel
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

import torch

from miner_tpu_torch.models import hf_import
from miner_tpu_torch.training import checkpoint

CONVERTERS = {
    "miner": lambda sd, n: hf_import.convert_miner_state_dict(sd, n),
    "fastformer": lambda sd, n: hf_import.convert_fastformer_state_dict(sd, n),
    "unbert": lambda sd, n: hf_import.convert_unbert_state_dict(sd),
    "unisrec": lambda sd, n: hf_import.unisrec_model_state_dict(sd, n),
}


def load_torch_state_dict(path: str, reference_repo: Optional[str]) -> Dict[str, torch.Tensor]:
    """The state dict of a reference checkpoint: a whole-module pickle's
    ``['model'].state_dict()``, a module's, or a bare state dict."""
    if reference_repo:
        sys.path.insert(0, reference_repo)
    try:
        payload = torch.load(path, map_location="cpu", weights_only=False)
    except Exception as e:
        raise SystemExit(f"could not unpickle {path}: {e}\n"
                         "whole-module reference checkpoints need --reference_repo "
                         "pointing at the reference source tree")
    if isinstance(payload, dict) and "model" in payload and hasattr(payload["model"],
                                                                  "state_dict"):
        return payload["model"].state_dict()
    if isinstance(payload, dict):
        return payload
    if hasattr(payload, "state_dict"):
        return payload.state_dict()
    raise SystemExit(f"unrecognized checkpoint payload type {type(payload)!r}")


def convert(sd: Dict[str, torch.Tensor], model_name: str, num_layers: int
            ) -> Dict[str, torch.Tensor]:
    """The port's state dict of a reference state dict, fp32 and contiguous."""
    sd = {k: v.detach() for k, v in sd.items() if isinstance(v, torch.Tensor)}
    state = CONVERTERS[model_name](sd, num_layers)
    return {k: v.float().contiguous() for k, v in state.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--torch_ckpt", required=True)
    ap.add_argument("--reference_repo", default=None,
                    help="reference source tree for unpickling whole modules")
    ap.add_argument("--num_layers", type=int, default=12,
                    help="PLM tower depth in the checkpoint")
    ap.add_argument("--model_name", default="miner", choices=sorted(CONVERTERS),
                    help="which reference model class the checkpoint holds")
    ap.add_argument("--legacy_history_layout", action="store_true",
                    help="acknowledge the converted model will run with "
                         "--legacy_history_layout (the reference's pads-first rows) — "
                         "required for the position-sensitive models")
    ap.add_argument("--force_layout_mismatch", action="store_true",
                    help="transfer a position-sensitive model anyway; it will see a "
                         "shifted input distribution under the default clicks-first layout")
    ap.add_argument("--out", required=True,
                    help="output port checkpoint file; pass it to --saved_model_path / "
                         "--pretrained_model_path")
    args = ap.parse_args(argv)
    hf_import.check_history_layout_for_transfer(args.model_name, args.legacy_history_layout,
                                                force=args.force_layout_mismatch)
    state = convert(load_torch_state_dict(args.torch_ckpt, args.reference_repo),
                    args.model_name, args.num_layers)
    print(f"converted {len(state)} tensors")
    checkpoint.save(args.out, {"params": state, "converted_from": "the reference"})
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The JAX package's legs of the shared-init trajectory pair, from the
port's init.

    python -m miner_tpu_torch.tools.quality_trajectory --out traj --init_seed 301 \\
        --export_init traj/init_ref.pt
    JAX_PLATFORMS=cpu python tools/import_reference_checkpoint.py \\
        --torch_ckpt traj/init_ref.pt --num_layers 2 --out traj/init_jax/portInit
    JAX_PLATFORMS=cpu python run_jax_trajectory_legs.py --out traj --init_seed 301 \\
        --init_ckpt traj/init_jax/portInit
    python -m miner_tpu_torch.tools.quality_trajectory --out traj --analyze

Run it where JAX is installed (it imports the JAX package, as
``convert_jax_checkpoint.py`` does; the port never does). It calls the JAX
tool's own ``run_jax_leg`` (``tools/quality_trajectory.py``) for each leg on
the corpus the port's tool wrote under ``--out/data``, at the JAX tool's
protocol (``quality_run``'s mid preset, 2 epochs, the pair seed
``--init_seed``), grafting the init from ``--init_ckpt``: each leg writes
``steps_jax-<A|B>.jsonl`` and ``result_jax-<A|B>.json`` beside the port's
legs, which the port's ``analyze`` reads.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True, help="the port tool's --out (its corpus in data/)")
    ap.add_argument("--init_seed", type=int, default=301)
    ap.add_argument("--init_ckpt", required=True,
                    help="the Orbax checkpoint tools/import_reference_checkpoint.py wrote")
    ap.add_argument("--legs", default="jax-A,jax-B")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tools import quality_run as qr
    from tools import quality_trajectory as qt

    qr._apply_preset("mid")
    qr.EPOCHS = 2
    qr.SEED = args.init_seed
    for leg in (x.strip() for x in args.legs.split(",") if x.strip()):
        if leg not in ("jax-A", "jax-B"):
            raise SystemExit(f"unknown JAX leg {leg!r} (jax-A or jax-B)")
        qt.run_jax_leg(os.path.join(args.out, "data"), args.out, leg, args.init_seed,
                       os.path.abspath(args.init_ckpt))
    return 0


if __name__ == "__main__":
    sys.exit(main())

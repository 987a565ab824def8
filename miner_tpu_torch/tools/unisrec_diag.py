"""UniSRec's from-scratch learnability on a planted-topic task, on the port.

The port's counterpart of the JAX package's ``tools/unisrec_diag.py``: a
tiny UniSRec (``PLMConfig.tiny`` tower, MoE adaptor, the 2-layer causal
SASRec tail) trains on batches where the first history click's topic is
the answer, with the training noise sources toggled, and each variant
prints its final train loss and its holdout accuracy (chance 1/5, loss
ln 5). The variants ask whether from scratch UniSRec sits at chance
because of its random tower and not because of its tail: ``bypass`` drops
the tail (score = candidate . first history news), ``reattach`` trains the
bypass first and then the whole model.

    python -m miner_tpu_torch.tools.unisrec_diag [--steps 400] [--lr 1e-3] [--device cpu]

The batches are the JAX tool's draw for draw (``make_batch``, numpy). The
model is the port's ``UniSRec`` built with the asked SASRec dropout;
initialised from a ``torch.Generator`` seeded with ``seed`` (or from a
given state, e.g. JAX's init carried by ``params_from_jax``), trained by
``torch.optim.Adam`` at optax's defaults, its dropout and gating noise
drawn from the port's ``DropoutRNG`` (the JAX tool's key ``seed + 100``).
On a card the tower runs the mha and add_ln kernels in float32.
"""
from __future__ import annotations

import argparse
import dataclasses as dc
import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

TOPICS, TOK_PER_TOPIC, LT, H, C, B = 8, 32, 12, 10, 5, 32
VOCAB = 2 + TOPICS * TOK_PER_TOPIC  # 0 pad, 1 cls
MODES = ("faithful", "bypass", "reattach")
# label, SASRec dropout, deterministic training, mode (the JAX tool's six)
VARIANTS = (
    ("faithful: seq dropout 0.5 + all train noise", 0.5, False, "faithful"),
    ("seq dropout 0.1 + all train noise          ", 0.1, False, "faithful"),
    ("seq dropout 0.0 + all train noise          ", 0.0, False, "faithful"),
    ("fully deterministic training (ceiling)     ", 0.5, True, "faithful"),
    ("bypass seq encoder (cand . first-his repr) ", 0.5, False, "bypass"),
    ("faithful tail re-attached after bypass warm", 0.5, False, "reattach"),
)


def make_batch(rng: np.random.Generator) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """One batch of B users: each user's H history titles are of one topic,
    and of the C candidates the one of that topic is the positive. Draws
    from ``rng`` in the JAX tool's order; the ids come back as int32 and the
    masks as float32, the arrays JAX's ``jnp.asarray`` makes of them."""
    def title(topic):
        body = rng.integers(0, TOK_PER_TOPIC, size=LT - 1) + 2 + topic * TOK_PER_TOPIC
        return np.concatenate([[1], body])

    user_topic = rng.integers(0, TOPICS, size=B)
    his = np.stack([np.stack([title(t) for _ in range(H)]) for t in user_topic])
    pos = rng.integers(0, C, size=B)
    cand = np.zeros((B, C, LT), dtype=np.int64)
    for b in range(B):
        negs = rng.choice([t for t in range(TOPICS) if t != user_topic[b]],
                          size=C - 1, replace=True)
        slots = list(negs)
        slots.insert(pos[b], user_topic[b])
        for c, t in enumerate(slots):
            cand[b, c] = title(t)
    return {
        "cand_title": cand.astype(np.int32),
        "cand_title_mask": np.ones((B, C, LT), np.float32),
        "his_title": his.astype(np.int32),
        "his_title_mask": np.ones((B, H, LT), np.float32),
        "his_mask": np.ones((B, H), np.float32),
    }, np.eye(C, dtype=np.float32)[pos]


def build_model(seq_dropout: float):
    """The tool's UniSRec: the tiny tower, the adaptor, and a SASRec tail
    whose hidden and attention dropout are ``seq_dropout`` (the module's
    ``sasrec_encoder_cfg`` replaced while the model is built)."""
    import miner_tpu_torch.models.unisrec as uni
    from miner_tpu_torch.models.news_encoder import NewsEncoderMoe
    from miner_tpu_torch.models.plm import PLMConfig

    orig_cfg = uni.sasrec_encoder_cfg

    def patched(hidden_size: int = 300):
        return dc.replace(orig_cfg(hidden_size), hidden_dropout=seq_dropout,
                          attention_dropout=seq_dropout)

    uni.sasrec_encoder_cfg = patched
    try:
        encoder = NewsEncoderMoe(PLMConfig.tiny(vocab_size=VOCAB))
        return uni.UniSRec(encoder, max_his_len=H)
    finally:
        uni.sasrec_encoder_cfg = orig_cfg


def run(seq_dropout: float, train_det: bool, lr: float, steps: int, seed: int = 0,
        mode: str = "faithful", device: Optional[str] = None,
        init_state: Optional[Mapping[str, torch.Tensor]] = None) -> Tuple[float, float]:
    """The final train loss and the holdout accuracy (8 batches) of one
    variant, as the JAX tool's ``run``: ``faithful`` trains the whole model,
    ``bypass`` the tower and adaptor alone (score = candidate . first
    history news), ``reattach`` ``steps`` steps of bypass then ``steps`` of
    the whole model. The holdout runs the deterministic whole model but in
    ``bypass``. ``init_state`` replaces the seeded init (loaded strictly)."""
    from miner_tpu_torch.models.dropout import DropoutRNG
    from miner_tpu_torch.utils import resolve_device

    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (use one of {MODES})")
    dev = resolve_device(device)
    model = build_model(seq_dropout)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if init_state is not None:
        model.load_state_dict(init_state, strict=True)
    model.to(dev)
    rng = np.random.default_rng(seed)
    make_batch(rng)  # the JAX tool's init batch: the draws stay in step
    # optax.adam's defaults
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def to_dev(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def bypass_logits(batch, drng):
        # the tower and adaptor alone, the encode path of UniSRec.forward;
        # the score is the candidates . the first history news
        Bc, Cc = batch["cand_title"].shape[:2]
        ids = torch.cat([batch["cand_title"].flatten(0, 1), batch["his_title"].flatten(0, 1)])
        mask = torch.cat([batch["cand_title_mask"].flatten(0, 1),
                          batch["his_title_mask"].flatten(0, 1)])
        reprs = model.encode_news(ids, mask, rng=drng)
        cand = reprs[:Bc * Cc].reshape(Bc, Cc, -1)
        his0 = reprs[Bc * Cc:].reshape(Bc, -1, reprs.shape[-1])[:, 0, :]
        return torch.einsum("bcd,bd->bc", cand, his0)

    def logits_of(batch, drng, bypass):
        return bypass_logits(batch, drng) if bypass else model(batch, drng)

    loss = None
    phases = {"faithful": [False], "bypass": [True], "reattach": [True, False]}[mode]
    step = 0
    model.train()
    for bypass in phases:
        for _ in range(steps):
            batch, label = make_batch(rng)
            batch, label = to_dev(batch), torch.as_tensor(label, device=dev)
            # deterministic training: no dropout and no gating noise
            drng = None if train_det else DropoutRNG(seed + 100, step, dev)
            logits = logits_of(batch, drng, bypass)
            loss = -(torch.log_softmax(logits.float(), -1) * label).sum(-1).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            for p in model.parameters():
                # optax's one step count: a parameter out of this phase's
                # graph (the tail in bypass) takes a zero gradient, so its
                # moments decay and its bias correction counts the step
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            opt.step()
            step += 1
    model.eval()
    accs = []
    with torch.no_grad():
        for _ in range(8):
            batch, label = make_batch(rng)
            logits = logits_of(to_dev(batch), None, mode == "bypass")
            accs.append(float((logits.argmax(-1).cpu() == torch.as_tensor(label).argmax(-1))
                              .float().mean()))
    return float(loss.detach()), float(np.mean(accs))


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv=None) -> list:
    args = make_parser().parse_args(argv)
    print(f"planted-topic task: chance acc = {1 / C:.2f}, chance loss = "
          f"{np.log(C):.3f}; {args.steps} steps, B={B}, lr={args.lr}", flush=True)
    rows = []
    for label, seq_do, det, mode in VARIANTS:
        t0 = time.time()
        loss, acc = run(seq_do, det, args.lr, args.steps, mode=mode, device=args.device)
        secs = time.time() - t0
        rows.append(dict(variant=label.strip(), loss=loss, acc=acc, seconds=secs))
        print(f"{label} loss {loss:.4f}  holdout acc {acc:.3f}  ({secs:.0f}s)", flush=True)
    return rows


if __name__ == "__main__":
    main()

"""The plain reference of the Miner's training step: the forward, the loss,
the backward by autograd, and AdamW, in float32 (or in the control's
precision, ``reference/precision.py``).

It follows the published model as the configuration runs it:

  * the news encoder: RoBERTa embeddings (word + position from
    ``position_offset`` + token type, LayerNorm), post-LN layers (fused qkv
    projection, softmax attention with masked keys at -1e9, dropout on the
    probabilities and on both residual branches, tanh GELU, as the
    configuration's ``gelu_approx`` states), the CLS state, ``reduce_dim``
    and its dropout; title and abstract combined by one linear layer;
  * the Miner's tail: category embeddings (pad row zero) with dropout, their
    pairwise cosine averaged over the candidates as the poly-attention bias,
    poly attention over the history with ``K`` context codes, per-interest
    dot products, the target-aware weighting (exact GELU, softmax over the
    interests);
  * the loss: cross-entropy over the candidates plus the mean pairwise
    cosine of the interests (diagonal zeroed);
  * AdamW as PyTorch's, under a global-norm clip and a linear warmup, the
    decay on every leaf of rank 2 or more that is no bias and no norm,
    gradients summed over ``accumulation`` micro-batches and divided.

Dropout draws the masks the configuration's dropout contract defines: a
micro-step's stream is seeded from (seed + 1, micro-step) by numpy's
``SeedSequence``; the host generator gives three Philox seeds a layer (title
layers first), the device generator the masks outside the layers, in the
order the model meets them (``reference/philox.py`` gives the layers'). A
micro-batch runs a few impressions at a time, each chunk's gradients summed,
so that the reference fits on the card.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference import philox
from reference.mind import Corpus, history_row
from reference.precision import Precision

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
NEG_INF = -1e9


def param_specs(cfg: Dict, num_categories: int) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    """(name, shape, mean, std) of every parameter: normal draws, in the
    order the weights are made. The names are the model's state-dict keys."""
    D, F_, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    W, K, P = cfg["word_embed_dim"], cfg["num_context_codes"], cfg["context_code_dim"]
    std = cfg["initializer_range"]
    out = []

    def dense(name, n_out, n_in, s=std):
        out.append((f"{name}.weight", (n_out, n_in), 0.0, s))
        out.append((f"{name}.bias", (n_out,), 0.0, std))

    def norm(name):
        out.append((f"{name}.weight", (D,), 1.0, std))
        out.append((f"{name}.bias", (D,), 0.0, std))

    p = "news_encoder.plm."
    out.append((p + "embeddings.word_embeddings.weight", (V, D), 0.0, std))
    out.append((p + "embeddings.position_embeddings.weight",
                (cfg["max_position_embeddings"], D), 0.0, std))
    out.append((p + "embeddings.token_type_embeddings.weight",
                (cfg["type_vocab_size"], D), 0.0, std))
    norm(p + "embeddings.ln")
    for i in range(cfg["num_hidden_layers"]):
        q = f"{p}layers.{i}."
        dense(q + "attention.qkv", 3 * D, D)
        dense(q + "attention.out", D, D)
        norm(q + "attention_ln")
        dense(q + "ffn_in", F_, D)
        dense(q + "ffn_out", D, F_)
        norm(q + "ffn_ln")
    dense("news_encoder.reduce_dim", W, D)
    dense("news_encoder.linear_combine", W, 2 * W)
    out.append(("category_embedding.weight", (num_categories, cfg["category_embed_dim"]),
                0.0, 1.0))
    out.append(("poly_attn.proj_kernel", (W, P), 0.0, 1.0 / math.sqrt(W)))
    out.append(("poly_attn.context_codes", (K, P), 0.0, math.sqrt(2.0 / (K + P)) * 5 / 3))
    out.append(("target_aware_attn.proj.weight", (W, W), 0.0, 1.0 / math.sqrt(W)))
    return out


def leaf_norms(tensors: Dict[str, torch.Tensor], hidden: int) -> Dict[str, float]:
    """Each leaf's norm; a fused qkv projection's query, key and value leaves
    apart (``name[q]``, ``name[k]``, ``name[v]``), as the published model
    holds them, so that the key's bias, whose gradient is nought under the
    softmax, is a leaf of its own."""
    out = {}
    for name, t in tensors.items():
        t = t.detach().float()
        if ".qkv." in name:
            for part, piece in zip("qkv", t.split(hidden, dim=0)):
                out[f"{name}[{part}]"] = float(torch.linalg.vector_norm(piece))
        else:
            out[name] = float(torch.linalg.vector_norm(t))
    return out


class Stream:
    """A micro-step's dropout draws (the configuration's contract)."""

    def __init__(self, seed: int, step: int, device):
        host_seed, device_seed = np.random.SeedSequence(
            [int(seed), int(step)]).generate_state(2, np.uint64)
        self.host = torch.Generator().manual_seed(int(host_seed))
        self.dev = torch.Generator(device=device).manual_seed(int(device_seed))
        self.device = torch.device(device)

    def seeds(self, n: int) -> List[int]:
        return torch.randint(0, 2 ** 63 - 1, (n,), generator=self.host).tolist()

    def keep(self, shape, rate: float) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.dev, device=self.device) >= rate


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def cosine(x, y, zero_diagonal=False):
    x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
    y = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=1e-12)
    sim = x @ y.transpose(-1, -2)
    if zero_diagonal:
        sim = sim * (1.0 - torch.eye(x.shape[-2], device=sim.device))
    return sim


class MinerReference:
    """The reference over one run's corpus and configuration; ``params``
    are float32 leaves (made from the run's seed, as the program's were)."""

    def __init__(self, cfg: Dict, corpus: Corpus, params: Dict[str, torch.Tensor],
                 precision: Precision):
        self.cfg, self.corpus, self.p, self.prec = cfg, corpus, params, precision
        self.device = next(iter(params.values())).device

    # ------------------------------------------------------------ news tower
    def _field(self, ids, keep_emb, seeds, rows, keep_red):
        cfg, p, prec = self.cfg, self.p, self.prec
        n, L = ids.shape
        D, H = cfg["hidden_size"], cfg["num_attention_heads"]
        hd, ad = cfg["hidden_dropout_prob"], cfg["attention_probs_dropout_prob"]
        eps = cfg["layer_norm_eps"]
        e = "news_encoder.plm.embeddings."
        pos = torch.arange(L, device=ids.device) + cfg["position_offset"]
        x = (p[e + "word_embeddings.weight"][ids] + p[e + "position_embeddings.weight"][pos][None]
             + p[e + "token_type_embeddings.weight"][0])
        x = prec.act(layer_norm(x, p[e + "ln.weight"], p[e + "ln.bias"], eps))
        x = torch.where(keep_emb, x / (1.0 - hd), 0.0)
        valid = (ids != 0)[:, None, None, :]
        tok_rows = (rows[:, None] * L + torch.arange(L, device=ids.device)).reshape(-1)
        for i, (s_attn, s_ln1, s_ln2) in enumerate(seeds):
            q = f"news_encoder.plm.layers.{i}."
            qkv = prec.linear(x, p[q + "attention.qkv.weight"], p[q + "attention.qkv.bias"])
            qh, kh, vh = (qkv[..., c * D:(c + 1) * D].reshape(n, L, H, D // H).transpose(1, 2)
                          for c in range(3))
            s = prec.matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(D // H))
            probs = prec.act(torch.softmax(torch.where(valid, s, NEG_INF), dim=-1))
            probs = torch.where(philox.mha_keep(s_attn, rows, H, L, ad), probs / (1.0 - ad), 0.0)
            ctx = prec.matmul(probs, vh).transpose(1, 2).reshape(n, L, D)
            h = prec.linear(ctx, p[q + "attention.out.weight"], p[q + "attention.out.bias"])
            keep = philox.add_ln_keep(s_ln1, tok_rows, D, hd).reshape(n, L, D)
            x = prec.act(layer_norm(x + torch.where(keep, h / (1.0 - hd), 0.0),
                                    p[q + "attention_ln.weight"], p[q + "attention_ln.bias"],
                                    eps))
            h = prec.act(F.gelu(prec.linear(x, p[q + "ffn_in.weight"], p[q + "ffn_in.bias"]),
                                approximate="tanh" if cfg["gelu_approx"] else "none"))
            h = prec.linear(h, p[q + "ffn_out.weight"], p[q + "ffn_out.bias"])
            keep = philox.add_ln_keep(s_ln2, tok_rows, D, hd).reshape(n, L, D)
            x = prec.act(layer_norm(x + torch.where(keep, h / (1.0 - hd), 0.0),
                                    p[q + "ffn_ln.weight"], p[q + "ffn_ln.bias"], eps))
        r = prec.linear(x[:, 0], p["news_encoder.reduce_dim.weight"],
                        p["news_encoder.reduce_dim.bias"])
        return torch.where(keep_red, r / (1.0 - cfg["dropout"]), 0.0)

    def _draws(self, N: int, stream: Stream) -> Dict:
        """The micro-step's dropout draws for the N news of the PLM call, in
        the order the program makes them: each field's embedding mask, its
        layers' kernel seeds and its reduce_dim mask, titles first."""
        cfg = self.cfg
        D, W = cfg["hidden_size"], cfg["word_embed_dim"]
        out = {}
        for name in ("title", "sapo"):
            L = cfg[f"max_{name}_length"]
            out[name] = (stream.keep((N, L, D), cfg["hidden_dropout_prob"]),
                         [stream.seeds(3) for _ in range(cfg["num_hidden_layers"])],
                         stream.keep((N, W), cfg["dropout"]))
        return out

    def _news(self, rows: np.ndarray, places: torch.Tensor, draws: Dict) -> torch.Tensor:
        """(n, W) vectors of the news ``rows`` (corpus rows) that sit at
        ``places`` in the PLM call."""
        cfg, dev = self.cfg, self.device
        parts = []
        for field, name in ((1, "title"), (3, "sapo")):
            ids = torch.as_tensor(self.corpus.tokens(rows, field, cfg[f"max_{name}_length"]),
                                  device=dev)
            keep_emb, seeds, keep_red = draws[name]
            parts.append(self._field(ids, keep_emb[places], seeds, places, keep_red[places]))
        return self.prec.linear(torch.cat(parts, dim=-1),
                                self.p["news_encoder.linear_combine.weight"],
                                self.p["news_encoder.linear_combine.bias"])

    # ------------------------------------------------------------------ loss
    def loss_and_grads(self, cand: np.ndarray, his: np.ndarray, label: np.ndarray,
                       stream: Stream, chunk: int = 4, half: bool = False):
        """(loss, {leaf: gradient}) of one micro-batch: the mean over its B
        impressions of the cross-entropy plus the interests' disagreement,
        ``chunk`` impressions at a time (each impression's term depends on
        its own news alone, so the chunks' gradients sum to the batch's).
        ``half``: a fault, the second half of the impressions left out and
        the mean taken over the rest."""
        cfg, p, prec, dev = self.cfg, self.p, self.prec, self.device
        B, C = cand.shape
        counted = B // 2 if half else B
        H = his.shape[1]
        draws = self._draws(B * (C + H), stream)
        Dc = cfg["category_embed_dim"]
        keep_his, keep_cand = stream.keep((B, H, Dc), cfg["dropout"]), stream.keep(
            (B, C, Dc), cfg["dropout"])
        pad = self.corpus.category2id["pad"]
        dr = cfg["dropout"]
        total = 0.0
        grads = {n: torch.zeros_like(t) for n, t in p.items()}
        for b0 in range(0, counted, chunk):
            b = np.arange(b0, min(b0 + chunk, counted))
            nb = len(b)
            c_places = (b[:, None] * C + np.arange(C)).reshape(-1)
            h_places = (B * C + b[:, None] * H + np.arange(H)).reshape(-1)
            places = torch.as_tensor(np.concatenate([c_places, h_places]), device=dev)
            reprs = self._news(np.concatenate([cand[b].reshape(-1), his[b].reshape(-1)]),
                               places, draws)
            cand_r, his_r = reprs[:nb * C].reshape(nb, C, -1), reprs[nb * C:].reshape(nb, H, -1)
            his_cat = torch.as_tensor(self.corpus.categories(his[b]), device=dev)
            cand_cat = torch.as_tensor(self.corpus.categories(cand[b]), device=dev)
            table = p["category_embedding.weight"]
            his_e = table[his_cat] * (his_cat != pad)[..., None]
            cand_e = table[cand_cat] * (cand_cat != pad)[..., None]
            his_e = torch.where(keep_his[b0:b0 + nb], his_e / (1.0 - dr), 0.0)
            cand_e = torch.where(keep_cand[b0:b0 + nb], cand_e / (1.0 - dr), 0.0)
            bias = cosine(his_e, cand_e).mean(-1)  # (nb, H)
            proj = torch.tanh(prec.matmul(his_r, p["poly_attn.proj_kernel"]))
            logits = prec.matmul(p["poly_attn.context_codes"], proj.transpose(-1, -2))
            logits = torch.where((his_cat != pad)[:, None, :], logits + bias[:, None, :],
                                 NEG_INF)
            interests = prec.matmul(torch.softmax(logits, dim=-1), his_r)  # (nb, K, W)
            scores = prec.matmul(cand_r, interests.transpose(-1, -2))  # (nb, C, K)
            t = F.gelu(prec.linear(interests, p["target_aware_attn.proj.weight"]))
            w = torch.softmax(prec.matmul(cand_r, t.transpose(-1, -2)), dim=-1)
            matching = (w * scores).sum(-1)
            target = torch.as_tensor(label[b], device=dev).argmax(-1)
            ce = -torch.log_softmax(matching, dim=-1).gather(-1, target[:, None])[:, 0]
            dis = cosine(interests, interests, zero_diagonal=True).mean(dim=(1, 2))
            part = (ce.sum() + dis.sum()) / counted
            got = torch.autograd.grad(part, list(p.values()), allow_unused=True)
            for (n, _), g in zip(p.items(), got):
                if g is not None:
                    grads[n] += g
            total += float(part.detach())
        return total, grads


def check_batch(corpus: Corpus, batch: Dict[str, np.ndarray], his_length: int) -> List[str]:
    """What is wrong with a micro-batch the program's data plane fed, against
    the behaviors it was drawn from: every row one clicked news of its
    impression and skipped ones, one positive label, its history."""
    faults = []
    imps = corpus.impressions()
    for b, line in enumerate(np.asarray(batch["impression_id"]).tolist()):
        imp = imps[line]
        cand, label = batch["cand_idx"][b], batch["label"][b]
        if int(np.sum(label)) != 1:
            faults.append(f"row {b}: {int(np.sum(label))} positive labels")
            continue
        at = int(np.argmax(label))
        if int(cand[at]) not in imp["pos"]:
            faults.append(f"row {b}: positive {int(cand[at])} not clicked in line {line}")
        others = [int(c) for i, c in enumerate(cand) if i != at]
        if any(c not in imp["neg"] for c in others):
            faults.append(f"row {b}: a negative not skipped in line {line}")
        if not np.array_equal(batch["his_idx"][b], history_row(imp["history"], his_length)):
            faults.append(f"row {b}: history is not line {line}'s")
    return faults


def lr_at(cfg: Dict, update: int, total: int, warmup: int) -> float:
    lr = cfg["learning_rate"]
    if update < warmup:
        return lr * min(update / max(warmup, 1), 1.0)
    return lr * max((total - update) / max(total - warmup, 1), 0.0)


def decays(name: str, shape) -> bool:
    last = name.rsplit(".", 1)[-1].lower()
    return len(shape) >= 2 and not any(k in last for k in ("bias", "scale", "ln", "layer_norm",
                                                           "layernorm"))


def follow(ref: MinerReference, batches: Sequence[Dict[str, np.ndarray]], updates: int,
           total: int, warmup: int, half: bool = False) -> Dict:
    """The first ``updates`` optimizer steps over ``batches`` (``updates`` x
    accumulation micro-batches): each micro-batch's loss, each leaf's norm of
    the first update's (clipped, averaged) gradient and of the parameters'
    change over the steps; a fused qkv leaf's three parts apart
    (``leaf_norms``)."""
    cfg, p = ref.cfg, ref.p
    accum = cfg["gradient_accumulation_steps"]
    start = {n: t.detach().clone() for n, t in p.items()}
    state = {n: (torch.zeros_like(t), torch.zeros_like(t)) for n, t in p.items()}
    losses, first_grad = [], None
    for u in range(updates):
        grads = {n: torch.zeros_like(t) for n, t in p.items()}
        for m in range(accum):
            step = u * accum + m
            b = batches[step]
            loss, got = ref.loss_and_grads(b["cand_idx"], b["his_idx"], b["label"],
                                           Stream(cfg["seed"] + 1, step, ref.device),
                                           half=half)
            for n, g in got.items():
                grads[n] += g
            losses.append(loss)
        with torch.no_grad():
            for g in grads.values():
                g /= accum
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads.values()]))
            if norm >= cfg["max_grad_norm"]:
                for g in grads.values():
                    g *= cfg["max_grad_norm"] / norm
            if u == 0:
                first_grad = leaf_norms(grads, cfg["hidden_size"])
            lr = lr_at(cfg, u, total, warmup)
            t = u + 1
            for n, w in p.items():
                m1, v1 = state[n]
                if decays(n, w.shape):
                    w.mul_(1.0 - lr * cfg["weight_decay"])
                m1.lerp_(grads[n], 1.0 - BETA1)
                v1.mul_(BETA2).addcmul_(grads[n], grads[n], value=1.0 - BETA2)
                denom = (v1 / (1.0 - BETA2 ** t)).sqrt() + EPS
                w.addcdiv_(m1, denom, value=-lr / (1.0 - BETA1 ** t))
    change = leaf_norms({n: p[n].detach() - start[n] for n in p}, cfg["hidden_size"])
    return {"losses": losses, "first_grad": first_grad, "change": change}


def _worst(prog: Dict[str, float], ref: Dict[str, float], names) -> Tuple[float, str]:
    """The worst leaf's gap between the two norms, against the larger of the
    reference's norm of that leaf and of the median leaf."""
    median = float(np.median([ref[n] for n in names]))
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def readings(prog: Dict, ref: Dict) -> Dict:
    """The numbers that decide ``correct``, of a run (``prog``: its losses,
    first gradient and change, as ``follow`` gives them) against the
    reference's: the largest relative gap of a micro-batch's loss; the worst
    leaf's gap of the first gradient's norm; the worst leaf's gap of the
    change's norm over the leaves the reference's first gradient moves (its
    norm at least a thousandth of the median leaf's: a key's bias, nought
    under the softmax, moves under AdamW by round-off alone)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    grad, grad_at = _worst(prog["first_grad"], ref["first_grad"], list(ref["first_grad"]))
    median = float(np.median(list(ref["first_grad"].values())))
    moved = [n for n, g in ref["first_grad"].items() if g >= 1e-3 * median]
    change, change_at = _worst(prog["change"], ref["change"], moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "worst_grad_leaf": grad_at, "worst_change_leaf": change_at,
            "left_out_of_change": sorted(set(ref["change"]) - set(moved))}

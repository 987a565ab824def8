"""News encoders: PLM tower -> fixed-size news representation.

Counterpart of ``miner_tpu/models/news_encoder.py``:

  * ``NewsEncoder``: title (and sapo) token ids run through the shared PLM,
    the CLS representation is taken, an optional ``reduce_dim`` linear maps
    it to ``word_embed_dim``, and the ``linear`` combine maps [title, sapo]
    to one vector. Under ``pre-concat`` the sapo tokens were appended to the
    title by the table (``NewsTable``: title + sapo[1:]), and the title
    branch alone runs (news_encoder.py:125-137). In training mode
    ``reduce_dim``'s output takes dropout at ``dropout`` (``--dropout``,
    news_encoder.py:95,122), its mask drawn from the step's ``DropoutRNG``.
    The ``lstm`` combine (``BiLSTMCombine``, news_encoder.py:34-70) runs a
    bidirectional LSTM over the length-2 sequence [title, sapo] and makes
    the news vector ``(base // 2) * 2`` wide, in fp32 whatever the compute
    type (flax promotes the cell's bf16 inputs to its fp32 parameters);
  * ``NewsEncoderMoe`` (UniSRec's, news_encoder.py:217-275): the CLS vector
    through ``MoEAdaptor``, 8 parametric-whitening experts mixed by softmax
    gates, 768 -> 300; no ``reduce_dim``.

The adaptor computes in its input's type (the tower's ``dtype``): its fp32
master parameters are cast at use, as flax's ``dtype`` casts them. Its gate
logits are a product in that type, the softmax runs in fp32 and the gates
are cast back (news_encoder.py:192-214).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from miner_tpu_torch.models.dropout import DropoutRNG, Rows, dropout_active
from miner_tpu_torch.models.plm import Dense, PLMConfig, TransformerPLM, lecun_normal_, normal_init_
from miner_tpu_torch.parallel.tp import copy_to_model, reduce_from_model


_GATES = ("i", "f", "g", "o")


class LSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell``: ``i, f, o = sigmoid(.)``, ``g =
    tanh(.)`` of ``x W_i* + h W_h* + b_h*``, then ``c' = f c + i g`` and
    ``h' = o tanh(c')``. The input kernels ``ii, if, ig, io`` (d_in -> H)
    have no bias, the recurrent ``hi, hf, hg, ho`` (H -> H) have one; the
    JAX tree's names. Computes in fp32: flax builds the cell without a
    ``dtype``, so its inputs are promoted to its fp32 parameters (and a
    parameter held in bf16 is widened)."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        for g in _GATES:
            self.add_module("i" + g, Dense(d_in, hidden, bias=False))
        for g in _GATES:
            self.add_module("h" + g, Dense(hidden, hidden))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun_normal input kernels, orthogonal
        recurrent kernels, zero biases."""
        for g in _GATES:
            w = self._modules["i" + g].weight
            lecun_normal_(w.data, w.shape[1], generator)
            nn.init.orthogonal_(self._modules["h" + g].weight, generator=generator)
            nn.init.zeros_(self._modules["h" + g].bias)

    def forward(self, x: torch.Tensor,
                carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, d_in) fp32, carry (c, h) or None (zeros) -> (c', h')."""
        w_i = torch.cat([self._modules["i" + g].weight for g in _GATES]).float()
        z = F.linear(x, w_i)
        if carry is None:  # h = 0: the recurrent product is its bias
            c = None
            z = z + torch.cat([self._modules["h" + g].bias for g in _GATES]).float()
        else:
            c, h = carry
            z = z + F.linear(h, torch.cat([self._modules["h" + g].weight
                                           for g in _GATES]).float(),
                             torch.cat([self._modules["h" + g].bias for g in _GATES]).float())
        zi, zf, zg, zo = z.chunk(4, dim=-1)
        new_c = torch.sigmoid(zi) * torch.tanh(zg)
        if c is not None:
            new_c = torch.sigmoid(zf) * c + new_c
        return new_c, torch.sigmoid(zo) * torch.tanh(new_c)


class BiLSTMCombine(nn.Module):
    """The ``lstm`` combine (``_BiLSTMCombine``, news_encoder.py:34-70): a
    bidirectional LSTM of hidden size H over the length-2 sequence [title,
    sapo], ``num_layers`` deep with dropout at ``dropout`` between layers
    (``--lstm_num_layers``, ``--lstm_dropout``), returning [forward after
    the sapo, backward] (B, 2H) in fp32. ``cells[2 i]`` is layer i's forward
    cell and ``cells[2 i + 1]`` its backward cell, as flax numbers them
    (``OptimizedLSTMCell_{j}``, bound to the combine, not to the RNNs).

    The reference's arithmetic is kept as its code has it, not as its
    docstring says: flax's ``nn.RNN(reverse=True)`` returns its outputs in
    processing order (``keep_order=False``), so the backward half of the
    result, ``b_seq[:, 0]``, is the backward cell after ONE step, over the
    sapo alone; and a next layer's input at step t is [forward output t,
    backward output t in processing order] (ROADMAP Queue 3)."""

    fp32_params = True  # serving's one-time cast leaves them fp32, as flax computes

    def __init__(self, d_in: int, hidden: int, num_layers: int = 1, dropout: float = 0.0):
        super().__init__()
        if num_layers < 1:
            raise ValueError(f"--lstm_num_layers must be at least 1, got {num_layers}")
        self.dropout = dropout
        self.cells = nn.ModuleList(
            LSTMCell(d_in if i < 2 else 2 * hidden, hidden) for i in range(2 * num_layers))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for cell in self.cells:
            cell.reset_parameters(generator)

    def forward(self, title_repr: torch.Tensor, sapo_repr: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        seq: List[torch.Tensor] = [title_repr.float(), sapo_repr.float()]
        layers = len(self.cells) // 2
        for i in range(layers):
            fwd, bwd = self.cells[2 * i], self.cells[2 * i + 1]
            f0 = fwd(seq[0])
            f1 = fwd(seq[1], f0)
            b0 = bwd(seq[1])  # the backward direction's first step: the sapo
            if i + 1 < layers:
                b1 = bwd(seq[0], b0)
                nxt = torch.stack([torch.cat([f0[1], b0[1]], dim=-1),
                                   torch.cat([f1[1], b1[1]], dim=-1)], dim=1)  # (B, 2, 2H)
                if dropout_active(self, rng, self.dropout):
                    nxt = rng.dropout(nxt, self.dropout)
                seq = list(nxt.unbind(1))
        return torch.cat([f1[1], b0[1]], dim=-1)


class NewsEncoder(nn.Module):
    def __init__(self, plm_cfg: PLMConfig, apply_reduce_dim: bool = True,
                 word_embed_dim: int = 256, use_sapo: bool = True,
                 combine_type: str = "linear", dropout: float = 0.2,
                 lstm_num_layers: int = 1, lstm_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if combine_type not in ("linear", "lstm", "pre-concat"):
            raise ValueError(f"unknown combine_type {combine_type!r}")
        self.plm_cfg = plm_cfg
        self.use_sapo = use_sapo
        self.combine_type = combine_type
        self.dropout = dropout
        self.plm = TransformerPLM(plm_cfg, dtype)
        base = word_embed_dim if apply_reduce_dim else plm_cfg.hidden_size
        self.reduce_dim = (Dense(plm_cfg.hidden_size, word_embed_dim)
                           if apply_reduce_dim else None)
        self.embed_dim = base
        self.linear_combine = self.lstm_combine = None
        if use_sapo and combine_type == "linear":
            self.linear_combine = Dense(2 * base, base)
        elif use_sapo and combine_type == "lstm":  # news_encoder.py:114-118
            self.embed_dim = (base // 2) * 2
            self.lstm_combine = BiLSTMCombine(base, base // 2, lstm_num_layers, lstm_dropout)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, initializer_range) Linear and Embedding weights (the JAX
        package's ``dense_init``); the LSTM cells take flax's own schemes."""
        normal_init_(self, self.plm_cfg.initializer_range, generator)
        if self.lstm_combine is not None:
            self.lstm_combine.reset_parameters(generator)

    def _combines(self) -> bool:
        """Whether a sapo branch runs and is combined with the title's."""
        return self.use_sapo and self.combine_type in ("linear", "lstm")

    def _field_repr(self, ids: torch.Tensor, mask: torch.Tensor,
                    rng: Optional[DropoutRNG]) -> torch.Tensor:
        repr_ = self.plm(ids, mask, rng=rng)[:, 0, :]
        if self.reduce_dim is not None:
            repr_ = self.reduce_dim(repr_)
            if dropout_active(self, rng, self.dropout):
                repr_ = rng.dropout(repr_, self.dropout)
        return repr_

    def forward(self, title_ids: torch.Tensor, title_mask: torch.Tensor,
                sapo_ids: Optional[torch.Tensor] = None,
                sapo_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        title_repr = self._field_repr(title_ids, title_mask, rng)
        if not self._combines():
            return title_repr
        sapo_repr = self._field_repr(sapo_ids, sapo_mask, rng)
        if self.lstm_combine is not None:
            return self.lstm_combine(title_repr, sapo_repr, rng)
        return self.linear_combine(torch.cat([title_repr, sapo_repr], dim=-1))

    def encode_batch(self, batch: Dict[str, torch.Tensor],
                     rng: Optional[DropoutRNG] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One PLM call per field over a model batch's candidates and
        history concatenated (``encode_all_news``, miner.py:112-136):
        (cand_repr (B, C, D), his_repr (B, H, D)). Over a data axis a
        rank's rows of the call are two runs of the global call's (its
        candidates', then its history's), where its dropout is drawn."""
        B, C = batch["cand_title"].shape[:2]
        H = batch["his_title"].shape[1]
        if rng is not None:
            rng = rng.at(Rows.concat(rng.rows_of(B * C), B * C, rng.rows_of(B * H)))

        def both(name):  # (B, C, L) and (B, H, L) -> (B*(C+H), L)
            return torch.cat([batch[f"cand_{name}"].flatten(0, 1),
                              batch[f"his_{name}"].flatten(0, 1)])

        sapo = sapo_mask = None
        if self._combines() and "cand_sapo" in batch:
            sapo, sapo_mask = both("sapo"), both("sapo_mask")
        reprs = self(both("title"), both("title_mask"), sapo, sapo_mask, rng)
        return (reprs[:B * C].reshape(B, C, -1), reprs[B * C:].reshape(B, H, -1))


class PWExperts(nn.Module):
    """All parametric-whitening experts as one batched product
    (news_encoder.py:147-175): ``dropout(x)`` once, then ``(x - bias_e) @
    kernel_e`` for every expert e. ``kernel`` (E, D_in, D_out) and ``bias``
    (E, D_in) keep the JAX tree's names and axis order."""

    def __init__(self, n_experts: int, d_in: int, out_dim: int, dropout: float = 0.2):
        super().__init__()
        self.dropout = dropout
        self.bias = nn.Parameter(torch.zeros(n_experts, d_in))
        self.kernel = nn.Parameter(torch.zeros(n_experts, d_in, out_dim))

    def forward(self, x: torch.Tensor, rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """(B, D_in) -> (B, E, D_out), in x's type."""
        if dropout_active(self, rng, self.dropout):
            x = rng.dropout(x, self.dropout)
        shifted = x[:, None, :] - self.bias.to(x.dtype)[None]  # (B, E, D_in)
        return torch.einsum("bei,eio->beo", shifted, self.kernel.to(x.dtype))


class MoEAdaptor(nn.Module):
    """Dense mixture of experts with noisy softmax gating
    (news_encoder.py:177-214): ``w_gate`` and ``w_noise`` are (D_in, E);
    in training mode the gate logits get ``normal * (softplus(x @ w_noise)
    + 1e-2)`` in the logits' type, the normal draws from the step's
    ``DropoutRNG``; the gates are an fp32 softmax cast to x's type; the
    output is the gate-weighted sum of the experts. Under expert parallelism
    (``parallel/tp.py``) the rank holds experts [``experts_share[0]``, ...)
    and its share of the sum is summed over the model group
    (``experts_share[1]``)."""

    experts_share = None

    def __init__(self, d_in: int, n_experts: int = 8, out_dim: int = 300,
                 dropout: float = 0.2, noise_epsilon: float = 1e-2):
        super().__init__()
        self.noise_epsilon = noise_epsilon
        self.w_gate = nn.Parameter(torch.zeros(d_in, n_experts))
        self.w_noise = nn.Parameter(torch.zeros(d_in, n_experts))
        self.experts = PWExperts(n_experts, d_in, out_dim, dropout)

    def reset_parameters(self, generator: torch.Generator, std: float = 0.02) -> None:
        """Zero gates and expert biases, N(0, std) expert kernels (JAX's
        initialisers)."""
        nn.init.zeros_(self.w_gate)
        nn.init.zeros_(self.w_noise)
        nn.init.zeros_(self.experts.bias)
        nn.init.normal_(self.experts.kernel, 0.0, std, generator=generator)

    def forward(self, x: torch.Tensor, rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        logits = x @ self.w_gate.to(x.dtype)
        if self.training and rng is not None:
            noise_std = F.softplus(x @ self.w_noise.to(x.dtype)) + self.noise_epsilon
            logits = logits + rng.normal(logits.shape, logits.dtype) * noise_std
        gates = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        if self.experts_share is None:
            return torch.einsum("be,beo->bo", gates, self.experts(x, rng))
        start, group = self.experts_share
        n = self.experts.kernel.shape[0]
        gates = copy_to_model(gates, group)[:, start:start + n]
        return reduce_from_model(torch.einsum("be,beo->bo", gates,
                                              self.experts(copy_to_model(x, group), rng)), group)


class NewsEncoderMoe(NewsEncoder):
    """The PLM tower and the MoE adaptor (UniSRec's news encoder): the CLS
    vector of each field through the adaptor (no ``reduce_dim``; the
    reference forces it off, news_encoder.py:254); ``linear`` combines the
    title's and sapo's adaptor outputs when ``use_sapo``, ``pre-concat``
    returns the title branch over the table's pre-concatenated titles."""

    def __init__(self, plm_cfg: PLMConfig, use_sapo: bool = False,
                 combine_type: str = "pre-concat", n_experts: int = 8,
                 adaptor_out_dim: int = 300, adaptor_dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        if use_sapo and combine_type == "lstm":  # JAX's raises at its first call
            raise ValueError("NewsEncoderMoe takes the linear and pre-concat combines, "
                             "not 'lstm' (miner_tpu/models/news_encoder.py:257-275)")
        super().__init__(plm_cfg, apply_reduce_dim=False, use_sapo=use_sapo,
                         combine_type=combine_type, dtype=dtype)
        self.moe_adaptor = MoEAdaptor(plm_cfg.hidden_size, n_experts, adaptor_out_dim,
                                      adaptor_dropout)
        self.embed_dim = adaptor_out_dim
        if self._combines():
            self.linear_combine = Dense(2 * adaptor_out_dim, adaptor_out_dim)

    def _field_repr(self, ids: torch.Tensor, mask: torch.Tensor,
                    rng: Optional[DropoutRNG]) -> torch.Tensor:
        return self.moe_adaptor(self.plm(ids, mask, rng=rng)[:, 0, :], rng)

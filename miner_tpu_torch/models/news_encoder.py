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
    The ``lstm`` combine is not ported yet (ROADMAP Queue 1, the other
    combines);
  * ``NewsEncoderMoe`` (UniSRec's, news_encoder.py:217-275): the CLS vector
    through ``MoEAdaptor``, 8 parametric-whitening experts mixed by softmax
    gates, 768 -> 300; no ``reduce_dim``.

The adaptor computes in its input's type (the tower's ``dtype``): its fp32
master parameters are cast at use, as flax's ``dtype`` casts them. Its gate
logits are a product in that type, the softmax runs in fp32 and the gates
are cast back (news_encoder.py:192-214).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from miner_tpu_torch.models.dropout import DropoutRNG, dropout_active
from miner_tpu_torch.models.plm import Dense, PLMConfig, TransformerPLM


class NewsEncoder(nn.Module):
    def __init__(self, plm_cfg: PLMConfig, apply_reduce_dim: bool = True,
                 word_embed_dim: int = 256, use_sapo: bool = True,
                 combine_type: str = "linear", dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if use_sapo and combine_type not in ("linear", "pre-concat"):
            raise NotImplementedError(
                f"--combine_type {combine_type!r} is not ported yet (ROADMAP Queue 1: the other "
                "combines); the port has the linear and pre-concat combines")
        self.plm_cfg = plm_cfg
        self.use_sapo = use_sapo
        self.combine_type = combine_type
        self.dropout = dropout
        self.plm = TransformerPLM(plm_cfg, dtype)
        base = word_embed_dim if apply_reduce_dim else plm_cfg.hidden_size
        self.reduce_dim = (Dense(plm_cfg.hidden_size, word_embed_dim)
                           if apply_reduce_dim else None)
        self.embed_dim = base
        self.linear_combine = Dense(2 * base, base) if self._combines() else None

    def _combines(self) -> bool:
        """Whether a sapo branch runs and is combined with the title's."""
        return self.use_sapo and self.combine_type == "linear"

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
        return self.linear_combine(torch.cat([title_repr, sapo_repr], dim=-1))

    def encode_batch(self, batch: Dict[str, torch.Tensor],
                     rng: Optional[DropoutRNG] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One PLM call per field over a model batch's candidates and
        history concatenated (``encode_all_news``, miner.py:112-136):
        (cand_repr (B, C, D), his_repr (B, H, D))."""
        B, C = batch["cand_title"].shape[:2]
        H = batch["his_title"].shape[1]

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
    output is the gate-weighted sum of the experts."""

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
        return torch.einsum("be,beo->bo", gates, self.experts(x, rng))


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

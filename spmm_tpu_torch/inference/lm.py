"""Turns of a decoder-only latent MoE model (``models.latent_moe``) over a
session cache: rows whose history is prefilled once and kept, each asked a
turn at a time.

``SessionCache`` holds B rows' latent cache [layers, B, positions, latent +
rope] (in the model's dtype) and each row's history length.
``prefill_history`` runs the rows' histories through the model once, rows
grouped so that a group's tokens fit ``PREFILL_TOKENS``.  ``answer_turn`` answers one turn a row:

1. prefill: the turn's tokens of every row at positions [history, history
   + n) against the row's cached history, in the expanded form
   (``LatentMoe.prefill``); the last position's argmax is the first answer
   token (spans ``spmm.lm.turn``, the root, and ``spmm.lm.prefill``);
2. decode: greedily through ``decoding.latent_decode`` (the runner that
   the k-beam and greedy decoders use, its graphs replayed on a card) with
   kernel 3, every row at its own position, no stop;
3. the answers copied to the host (``spmm.to_host``).

Each call starts every row at its history length again, so a turn
overwrites the last turn's positions and the rows' histories stay as
prefilled.
"""

from __future__ import annotations

import numpy as np
import torch

from spmm_tpu_torch.inference.decoding import latent_decode
from spmm_tpu_torch.models.latent_moe import LatentMoe
from spmm_tpu_torch.utils.spans import span

PREFILL_TOKENS = 16384   # tokens a prefill group of histories


class SessionCache:
    """``rows`` sessions of up to ``positions`` tokens each on ``device``,
    the cache in the model's dtype."""

    def __init__(self, model: LatentMoe, rows: int, positions: int, device):
        cfg = model.cfg
        self.cache = torch.zeros((cfg.num_hidden_layers, rows, positions,
                                  cfg.latent_dim), dtype=model.embed.dtype,
                                 device=device)
        self.history = [0] * rows

    @property
    def rows(self) -> int:
        return self.cache.shape[1]

    @property
    def positions(self) -> int:
        return self.cache.shape[2]


def _prefill(model: LatentMoe, session: SessionCache, runs: list
             ) -> torch.Tensor:
    """(row, start, token ids [n] on the device) runs through the model into
    the rows' caches; the logits after each run's last token."""
    dev = session.cache.device
    segments, off = [], 0
    for row, start, ids in runs:
        n = ids.shape[0]
        if start + n > session.positions:
            raise ValueError(f"row {row}: {start + n} positions, the cache "
                             f"holds {session.positions}")
        segments.append((row, start, n, off))
        off += n
    tokens = torch.cat([ids for _, _, ids in runs])
    pos = torch.cat([torch.arange(start, start + ids.shape[0], device=dev)
                     for _, start, ids in runs])
    row_ids = torch.cat([torch.full((ids.shape[0],), row, device=dev)
                         for row, _, ids in runs])
    return model.prefill(session.cache, tokens, pos, row_ids, segments)


@torch.no_grad()
def prefill_history(model: LatentMoe, session: SessionCache,
                    histories: list) -> None:
    """Each row's history (a 1-D int64 tensor on the cache's device, row r
    the r-th) written into the session cache, in groups of rows of at most
    ``PREFILL_TOKENS`` tokens (a longer history alone)."""
    if len(histories) != session.rows:
        raise ValueError(f"{len(histories)} histories for {session.rows} rows")
    group, size = [], 0
    for row, ids in enumerate(histories):
        n = ids.shape[0]
        if group and size + n > PREFILL_TOKENS:
            _prefill(model, session, group)
            group, size = [], 0
        group.append((row, 0, ids))
        size += n
    if group:
        _prefill(model, session, group)
    session.history = [int(ids.shape[0]) for ids in histories]


@torch.no_grad()
def answer_turn(model: LatentMoe, session: SessionCache, turn: torch.Tensor,
                n_answer: int, eager: bool = False) -> dict:
    """One turn a row: ``turn`` [B, n] token ids on the cache's device, each
    row's appended to its history; ``n_answer`` tokens a row answered
    greedily.  Returns host arrays ``answers`` [B, n_answer] and ``steps``
    (decode steps run: ``n_answer - 1``).  ``eager`` runs the decode's
    steps from Python (the reference its graphs are held to)."""
    b, n = turn.shape
    if b != session.rows:
        raise ValueError(f"{b} turns for {session.rows} rows")
    if max(session.history) + n + n_answer - 1 > session.positions:
        raise ValueError("the answers would run past the cache")
    with span("spmm.lm.turn"):
        with span("spmm.lm.prefill"):
            logits = _prefill(model, session, [
                (row, session.history[row], turn[row]) for row in range(b)])
            first = logits.argmax(dim=-1)
        start = torch.tensor([h + n for h in session.history],
                             device=turn.device)
        out = latent_decode(model, session.cache, first, start, n_answer,
                            eager=eager)
        with span("spmm.to_host"):
            answers = out["answers"].cpu().numpy()
    return {"answers": answers.astype(np.int64), "steps": out["steps"]}

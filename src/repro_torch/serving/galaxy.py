"""Galaxy HMP executor: serve through the paper-exact schedule.

Bridges the serving engine (``serving/engine.py``) and the heterogeneity-
aware HMP executor (``core/hmp.py``) through the paged protocol: prefill
runs the full TP/SP + ring program over the ring devices and scatters the
prompt's K/V straight into this request's pool pages; decode runs the
single-token TP step of the slot batch against the pages, each device
touching only its own head shard.  Both run under the uneven ``ExecPlan``
the planner produced.

The prompt is scattered into the plan's padded ragged layout
(``ExecPlan.seq_layout``) and the output gathered back, so uneven sequence
tiles and non-dividing lengths run exactly.  K/V land at absolute
positions, and each decode step overwrites its own page entry before
attending, so bucket-padding positions are never read.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core import hmp
from repro_torch.core.execplan import ExecPlan
from repro_torch.core.ring import LocalRing


class GalaxyHMPExecutor:
    """Paged executor protocol over HMP layers.

    layers: stack of layer params in *reference* layout; padded and split
            into per-device shards once here.
    embed:  (vocab, d_model) tied embedding / unembedding table; its device
            and dtype are the executor's.
    plan:   compute backend and ring transport come from the plan
            (``ExecPlan.with_backend`` / ``with_transport``); prefill always
            runs the overlapped ring.
    """

    def __init__(self, layers: Sequence[Dict], embed: torch.Tensor,
                 plan: ExecPlan, ring: LocalRing):
        if plan.num_devices != ring.num_devices:
            raise ValueError(f"plan covers {plan.num_devices} devices but the "
                             f"ring has {ring.num_devices}")
        self.plan = plan
        self.ring = ring
        self.layers = [hmp.shard_layer_params(plan, p) for p in layers]
        self.embed = embed
        self.device = embed.device

    @property
    def prompt_pad_multiple(self) -> int:
        """Plan-derived prompt bucketing grain.  The ragged SP layout makes
        any length correct; bucketing only bounds the distinct shapes."""
        return self.plan.seq_grain

    @property
    def supports_paged(self) -> bool:
        return True

    def make_pool(self, num_pages: int, page_size: int) -> List[Dict]:
        return hmp.make_paged_kv_cache(
            num_pages, page_size, len(self.layers), self.plan,
            device=self.device, dtype=self.embed.dtype,
        )

    def _tensor(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.asarray(a))
        return a.to(self.device).long()

    def prefill_paged(self, tokens, pool, block_row, length: int):
        """Prefill one request (batch 1, tokens bucket-padded by the engine)
        writing its K/V straight into its pool pages.  Returns the logits
        of the last real prompt token, (1, V), and the pool."""
        tokens = self._tensor(tokens)
        s = tokens.shape[1]
        layout = self.plan.seq_layout(s)
        x = self.embed[layout.scatter(tokens)]  # (1, padded, d)
        y, pool = hmp.hmp_prefill(
            self.layers, x, self.ring, pool, plan=self.plan,
            overlap=True, seq=s, block_row=self._tensor(block_row),
        )
        y = layout.gather(y)
        return y[:, length - 1] @ self.embed.T, pool

    def decode_paged(self, tokens, pool, block_table, positions):
        """One decode step of the slot batch: tokens (S, 1), block_table
        (S, W), positions (S,).  Returns (logits (S, V), pool)."""
        x = self.embed[self._tensor(tokens)]  # (S, 1, d)
        y, pool = hmp.hmp_decode(
            self.layers, x, self.ring, pool, self._tensor(positions),
            plan=self.plan, block_table=self._tensor(block_table),
        )
        return y[:, -1] @ self.embed.T, pool

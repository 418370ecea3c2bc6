"""Activation sharding hooks of the LM on one card.

The port of the reference's ``models.sharding`` as far as serving on one
card needs it: ``ShardCfg`` without a mesh and ``NO_SHARD``, whose
``act_residual`` / ``act_logits`` hooks are identities.  The reference's
spec functions (``param_specs``, ``zero1_specs``, ``batch_specs``,
``cache_specs``) and its mesh axes place parameters, optimizer state and
caches over a device mesh; they come with the port's multi-card training
and launch path, and until then a mesh is refused.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class ShardCfg:
    mesh: Optional[Any] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "the port serves on one card: ShardCfg takes no mesh")

    def act_residual(self, x):
        """(B,S,d) residual stream: unconstrained on one card."""
        return x

    def act_logits(self, x):
        return x


NO_SHARD = ShardCfg()

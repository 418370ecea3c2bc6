"""The task protocol of the wave drivers (the reference's ``core/dnd.py``).

Only ``_Spawn`` is here so far: the message a work-yielding task yields
to run subtasks, which ``service.scheduler`` and ``service.router``
speak.  It is defined beside the ND task tree in ``core.nd``, which
yields it, so that this module may import ``core.nd`` when the
distributed slice fills it with the distributed ordering
(``DNDConfig``, ``distributed_nested_dissection`` and its work kinds).
"""
from __future__ import annotations

from repro_torch.core.nd import _Spawn

__all__ = ["_Spawn"]

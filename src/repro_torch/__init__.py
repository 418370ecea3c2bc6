"""PyTorch/CUDA port of the PT-Scotch reproduction (``repro``).

Host nested dissection (``core.nd.nested_dissection``) with its device
works on one NVIDIA H100: heavy-edge matching as batched torch ops, and
hand-written CUDA kernels for the band distance sweep
(``kernels.band_batch``) and the fused FM pass loop (``kernels.fm_fused``).
Module names follow ``repro``'s so each counterpart is easy to find.

Entry points take a ``device`` argument that defaults to ``"cuda"`` and
raise when no card is present, unless the caller asks for ``"cpu"``;
there each kernel's plain torch version runs instead.
"""

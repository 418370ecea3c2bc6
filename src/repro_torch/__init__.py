"""PyTorch/CUDA port of the PT-Scotch reproduction (``repro``).

Host nested dissection (``core.nd.nested_dissection``) with its device
works on one NVIDIA H100, as hand-written CUDA kernels for the
reference's XLA heavy-edge matching (``kernels.matching``) and for every
Pallas kernel of the reference: the
band distance sweep and the FM gains (``kernels.band_batch``), the fused
FM pass loop and the hoisted path's one-pass move loop
(``kernels.fm_fused``), the ELL SpMV (``kernels.ell_spmv``) and the
diffusion step (``kernels.diffusion``).  ``kernels.ops`` holds the public
batched entries and the ``REPRO_FM_MODE`` switch.  Module names follow
``repro``'s so each counterpart is easy to find.  The LM scaffold's
serving path (``configs``, ``models``, ``serve.engine``, ``flopcount``)
is plain PyTorch: the reference's LM has no Pallas kernel.

Entry points take a ``device`` argument that defaults to ``"cuda"`` and
raise when no card is present, unless the caller asks for ``"cpu"``;
there each kernel's plain torch version runs instead.
"""

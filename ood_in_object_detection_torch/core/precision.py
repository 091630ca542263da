"""The port's f32 contract: f32 arithmetic, with TF32 off.

PyTorch lets cuDNN run f32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which rounds their inputs to
a 10-bit mantissa on the card. The JAX package's CLIs evaluate in f32, with
``--bf16`` as the only reduced-precision option, so every entry point of the
port switches TF32 off for cuDNN convolutions and for CUDA matmuls where it
picks its device (``cli/ood_eval.py:torch_device``, the embedding plot,
``scripts/serve_bundle.py``). The flags are process-wide: ranks spawned by
``parallel/distributed.py`` take the parent's. A ``Detector`` or
``MicroBatchServer`` built as a library keeps whatever its process set.
"""

from __future__ import annotations

import torch


def disable_tf32() -> None:
    """cuDNN convolutions and CUDA matmuls in full f32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

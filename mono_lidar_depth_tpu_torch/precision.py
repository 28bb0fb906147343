"""Float32 matmul policy for the port.

The JAX package pins its residual-critical products to exact f32
(`precision=HIGHEST`, `f32_matmuls`) because TPU matmuls default to
bf16 inputs.  On an NVIDIA card the hazard is TF32: PyTorch runs fp32
convolutions through cuDNN in TF32 by default (`cudnn.allow_tf32`), and
a user may have switched matmuls to TF32.  TF32 keeps ~3 decimal
digits, which corrupts the GN/BA Schur chain the same way bf16 did on
the TPU (vo/linalg6.py).  The port therefore runs every product in full
fp32: `enforce_fp32()` turns both TF32 switches off, and
`fp32_enforced()` checks that they are still off.
"""

from __future__ import annotations

import torch


def enforce_fp32() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp32_enforced() -> bool:
    """True when neither matmuls nor cuDNN convolutions may use TF32."""
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")

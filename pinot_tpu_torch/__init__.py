"""pinot_tpu_torch — the PyTorch/CUDA port of pinot_tpu for one NVIDIA H100.

The JAX package (``pinot_tpu``) stays beside it as the reference. This
package imports torch and never jax, and nothing of ``pinot_tpu``: the
jax-free modules it needs (SQL front end, segment format, reduce) are
copies kept here. Columnar segments live on the card as padded (S, L)
CUDA tensors; filters and expressions run as torch ops; the dense
group-by sums and min/max run through hand-written CUDA kernels
(``csrc/``, bound in ``ops/kernels.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the tests do); a kernel wrapper given CPU tensors runs the kernel's
plain PyTorch version, and given CUDA tensors launches the kernel or
raises.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA card, raising when there is none: the port
    never drops to the CPU on its own. Any other value is taken as
    given (``"cpu"`` for the tests)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)

"""MP-MVS on PyTorch and CUDA: the port of ``mpmvs_tpu`` to an NVIDIA H100.

The same PatchMatch multi-view stereo as the JAX package (bilateral-NCC
PatchMatch with adaptive checkerboard propagation and multi-view fusion,
after MP-MVS, arXiv:2309.13294), written as eager PyTorch around a
hand-written CUDA kernel for the NCC hot loop (``csrc/ncc_eval.cu``). This
package never imports JAX; tests hold it against ``mpmvs_tpu``.
"""

__version__ = "0.1.0"

from mpmvs_torch.camera import Camera, CameraStack
from mpmvs_torch.params import ConfigParams, PatchMatchParams

__all__ = ["Camera", "CameraStack", "ConfigParams", "PatchMatchParams"]

"""unet_studio_tpu_torch — the PyTorch/CUDA port of unet_studio_tpu.

The same U-Net segmentation system, run on an NVIDIA H100: plain tensor
code is PyTorch, and the Pallas kernels of the JAX package are CUDA
kernels written for Hopper (``csrc/``).  Activations keep the JAX
package's channels-last ``(D, H, W, C)`` layout at every public function.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``); with no card and no such request
they raise.  On the CPU every kernel wrapper runs its plain PyTorch twin.
"""

__version__ = "0.1.0"

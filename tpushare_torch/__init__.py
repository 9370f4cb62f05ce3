"""PyTorch / CUDA port of tpushare, for NVIDIA Hopper.

Mirrors the layout of :mod:`tpushare`: the code that runs on the card
(the flagship LM, its serving and training paths and the flash-attention
kernels), the tenant half of the grant contract, the node daemon, and
the scheduler extender that places the tenants. It imports nothing from
:mod:`tpushare`; the JAX package stays the reference.
"""

__version__ = "0.5.0"

"""Kernels and passes of the free-running CGGibbs engine, and the lockstep
engine's batched slice kernels."""

from .slice_kernels import (
    SLICE_KERNELS,
    SliceKernel,
    SliceResult,
    SliceRNG,
    get_slice_kernel,
    register_slice_kernel,
    slice_doubling,
    slice_elliptical,
    slice_genelliptical,
    slice_latent,
    slice_quantile,
    slice_stepping_out,
    slice_stepping_out_batched,
)

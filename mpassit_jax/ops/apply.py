"""Weight application — the hot path (ESMF_FieldBundleRegrid replacement).

The route-handle apply of the reference (interp.F90:134, a distributed sparse
mat-vec inside ESMF) becomes a jitted gather + weighted sum over the static
ELL operator:

    out[t, c] = sum_k w[t, k] * src[idx[t, k], c]

``c`` is the batched minor dimension stacking vertical levels x variables —
the FieldBundle amortization (interp.F90:123-136) — so each gathered source
row is a wide contiguous read. K is a compile-time constant (3 bilinear, 1 nearest,
bounded conservative); the K-loop is unrolled so XLA fuses the multiply-adds
into the gathers without materializing a (T, K, C) temporary.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from functools import partial

from ..weights.ell import ELLWeights


@partial(jax.jit, static_argnames=("out_dtype",))
def apply_ell(idx, w, src, out_dtype=None):
    """Core apply. idx/w: (T, K); src: (n_src, C) or (n_src,).

    Accumulates in w's dtype (elementwise multiply-adds, no contraction,
    so no matmul precision applies); output cast to out_dtype."""
    squeeze = src.ndim == 1
    if squeeze:
        src = src[:, None]
    acc_dtype = w.dtype
    srcw = src.astype(acc_dtype)
    out = None
    for k in range(idx.shape[1]):
        term = w[:, k, None] * jnp.take(srcw, idx[:, k], axis=0)
        out = term if out is None else out + term
    if out_dtype is not None:
        out = out.astype(out_dtype)
    return out[:, 0] if squeeze else out


class Regridder:
    """Device-resident ELL operator with column chunking.

    The analog of a stored ESMF route handle: build once, apply to any number
    of field stacks (interp.F90 builds 10+ route handles per run; we cache
    and reuse — see weights/cache.py).
    """

    def __init__(self, ell: ELLWeights, dtype=jnp.float32,
                 max_cols: int = 256, device=None):
        self.method = ell.method
        self.src_loc = ell.src_loc
        self.dst_shape = tuple(ell.dst_shape)
        self.n_src = ell.n_src
        self.max_cols = max_cols
        put = (lambda a: jax.device_put(a, device)) if device else jax.device_put
        self.idx = put(jnp.asarray(ell.idx, dtype=jnp.int32))
        self.w = put(jnp.asarray(ell.w, dtype=dtype))

    @property
    def n_dst(self) -> int:
        return self.idx.shape[0]

    def __call__(self, src, out_dtype=None):
        """src: (n_src,) or (n_src, C) array-like. Returns a jax array
        (dst_shape...) or (dst_shape..., C)."""
        src = jnp.asarray(src)
        if src.shape[0] != self.n_src:
            # XLA gather clamps out-of-range indices silently; catch shape
            # mistakes here instead of returning garbage.
            raise ValueError(
                f"source has {src.shape[0]} rows, operator expects {self.n_src}"
            )
        if src.ndim == 1:
            out = apply_ell(self.idx, self.w, src, out_dtype=out_dtype)
            return out.reshape(self.dst_shape)
        C = src.shape[1]
        if C <= self.max_cols:
            out = apply_ell(self.idx, self.w, src, out_dtype=out_dtype)
        else:
            chunks = [
                apply_ell(self.idx, self.w, src[:, lo:lo + self.max_cols],
                          out_dtype=out_dtype)
                for lo in range(0, C, self.max_cols)
            ]
            out = jnp.concatenate(chunks, axis=1)
        return out.reshape(self.dst_shape + (C,))

    def apply_np(self, src, out_dtype=None, root_only: bool = False):
        """root_only: only process 0 materializes the host copy (terminal
        fields; see parallel/multihost.fetch_to_host). Single-device
        results are process-local, so non-primary processes just return a
        zero-stride broadcast view of the right shape."""
        out = self(src, out_dtype=out_dtype)
        if root_only:
            from ..parallel.multihost import is_primary

            if not is_primary():
                return np.broadcast_to(np.zeros((), dtype=out.dtype),
                                       out.shape)
        return np.asarray(out)

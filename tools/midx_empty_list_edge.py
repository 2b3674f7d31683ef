#!/usr/bin/env python3
"""Measure the JAX reference's midx stage-1 edge at youtube-dnn's full width.

The reference draws posting lists with ``blocks.categorical_rows``: an
inverse CDF over an fp32 ``cumsum`` of the list probabilities, clipped to
the last list.  At 100,000 rows in lists of 256 there are 512 lists and
the last 121 are empty, so a uniform that lands above the cumsum's last
entry is clipped onto an EMPTY list, whose within-list logits are all
-inf and whose logq is NaN.  This script builds the reference index of a
seeded head at full width, reports how far each query's cdf[-1] falls
short of 1, where a uniform just below 1 lands, and counts NaN logq over
60 steps' worth of reference draws.  CPU only; about a minute.

Run from the repo root:  PYTHONPATH=src python3 tools/midx_empty_list_edge.py
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.core import kernel_fns, midx

N, D, T, M, STEPS = 100_000, 128, 256, 128, 60


def main() -> None:
    rng = np.random.default_rng(0)
    w = jnp.asarray((rng.normal(size=(N, D)) * 30 / np.sqrt(N))
                    .astype(np.float32))
    h = jnp.asarray(rng.normal(size=(T, D)).astype(np.float32))
    st = jax.jit(lambda w_: midx.build(w_, codewords=16, codebooks=2,
                                       list_size=256))(w)
    cnt = np.asarray(st.cnt)
    print(f"lists {st.num_lists}, empty {int((cnt == 0).sum())}, "
          f"last list count {cnt[-1]}")
    kernel = kernel_fns.quadratic_kernel(100.0)
    logits = midx.list_log_masses(st, kernel, h, use_kernels=False)
    cdf = jnp.cumsum(jax.nn.softmax(logits, axis=-1), axis=-1)
    short = 1.0 - np.asarray(cdf[:, -1], np.float64)
    print(f"1 - cdf[-1] over {T} queries: max {short.max():.3e}, mean "
          f"{short.mean():.3e}; {int((short > 0).sum())} queries short")
    u = jnp.full((T, 1), 1.0 - 2.0 ** -23, jnp.float32)
    idx = jax.vmap(lambda c, uu: jnp.searchsorted(c, uu, side="right"))(
        cdf, u)
    idx = np.minimum(np.asarray(idx)[:, 0], st.num_lists - 1)
    print(f"a uniform of 1 - 2^-23 lands on an empty list for "
          f"{int((cnt[idx] == 0).sum())} of {T} queries")
    draw = jax.jit(lambda s, h_, k: midx.sample_batch(
        s, kernel, h_, M, k, use_kernels=False))
    nan = sum(int(np.isnan(np.asarray(draw(st, h, jax.random.PRNGKey(i))[1]
                                      )).sum()) for i in range(STEPS))
    print(f"NaN logq over {STEPS} x {T * M} reference draws: {nan}")


if __name__ == "__main__":
    main()

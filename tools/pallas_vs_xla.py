"""The dense SQUAREM block as a Pallas kernel through the Triton route
against the plain XLA path (``model/dense.py::_dense_solve_jax``).

The measurement that decided the dense solver stays plain XLA: the kernel
body here is the one the solver once ran through Pallas, written for the
Triton backend (one launch per block of ``tile_b`` modules).  Both paths
solve the same batches to the same epsilon; per class it prints the
median warm time, the first-call (compile) time, the block count and the
log-likelihood gap between the two.

    python tools/pallas_vs_xla.py check              # 16 synthetic modules per class
    python tools/pallas_vs_xla.py time FASTA READS   # the classes of one SE l76 sample

On a machine without a GPU (``JAX_PLATFORMS=cpu``) the kernel runs in
Pallas's interpret mode, which checks it but times nothing useful.
"""
import functools
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ON_GPU = os.environ.get("JAX_PLATFORMS", "") != "cpu"

from emsar_jax.model import dense as D  # noqa: E402


def _pallas_block(m, eumaps, reads, inv_denom, theta, n_iters, tile_b):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltr

    B, C, T = m.shape

    def kernel(m_ref, e_ref, r_ref, inv_ref, th_ref, out_ref):
        mm = m_ref[...]
        ee = e_ref[...]
        rr = r_ref[...]
        inv = inv_ref[...]

        def intens(th):
            return jnp.sum(mm * th[:, None, :], axis=2)

        def em(th):
            s = intens(th)
            ratio = jnp.where(s > 0, rr / jnp.where(s > 0, s, 1.0), 0.0)
            num = jnp.sum(mm * ratio[:, :, None], axis=1)
            return th * num * inv

        def body(_, th):
            t1 = em(th)
            t2 = em(t1)
            r = t1 - th
            v = t2 - t1 - r
            rn = jnp.sqrt(jnp.sum(r * r, axis=1, keepdims=True))
            vn = jnp.sqrt(jnp.sum(v * v, axis=1, keepdims=True))
            alpha = jnp.minimum(
                jnp.where(vn > 0, -rn / jnp.where(vn > 0, vn, 1.0), -1.0),
                -1.0)
            extrap = th - 2.0 * alpha * r + alpha * alpha * v
            cand = em(jnp.where(extrap > 0, extrap, t2))
            lam2 = intens(t2)
            lamc = intens(cand)
            both = (lam2 > 0) & (lamc > 0)
            ratio = jnp.log1p(jnp.where(both, (lamc - lam2) /
                                        jnp.where(both, lam2, 1.0), 0.0))
            died = (lam2 > 0) & (lamc <= 0) & (rr > 0)
            born = (lam2 <= 0) & (lamc > 0) & (rr > 0)
            term = jnp.where(both, rr * ratio,
                             jnp.where(died, -1e30,
                                       jnp.where(born, 1e30, 0.0)))
            gain = jnp.sum(term - ee * (lamc - lam2), axis=1, keepdims=True)
            return jnp.where(gain >= 0, cand, t2)

        out_ref[...] = jax.lax.fori_loop(0, n_iters, body, th_ref[...])

    spec3 = pl.BlockSpec((tile_b, C, T), lambda i: (i, 0, 0))
    spec_c = pl.BlockSpec((tile_b, C), lambda i: (i, 0))
    spec_t = pl.BlockSpec((tile_b, T), lambda i: (i, 0))
    kw = dict(backend="triton",
              compiler_params=pltr.CompilerParams(num_warps=4, num_stages=1)) \
        if ON_GPU else dict(interpret=True)
    return pl.pallas_call(
        kernel, grid=(B // tile_b,),
        in_specs=[spec3, spec_c, spec_c, spec_t, spec_t], out_specs=spec_t,
        out_shape=jax.ShapeDtypeStruct(theta.shape, theta.dtype),
        name="dense_em_block", **kw)(m, eumaps, reads, inv_denom, theta)


@functools.partial(jax.jit, static_argnames=("B", "C", "T", "block_iters",
                                             "max_blocks", "tile_b"))
def _dense_solve_pallas(flat_idx, eumaps, reads, epsilon, B, C, T,
                        block_iters, max_blocks, tile_b):
    m, inv_denom = D._prep_dense(flat_idx, eumaps, B, C, T)
    prec = jax.lax.Precision.HIGHEST
    theta0 = jnp.einsum("bct,bc->bt", m, reads, precision=prec) * inv_denom

    def intens(th):
        return jnp.einsum("bct,bt->bc", m, th, precision=prec)

    def gain_rows(s_old, s_new):
        both = (s_old > 0) & (s_new > 0)
        ratio = jnp.log1p(jnp.where(both, (s_new - s_old) /
                                    jnp.where(both, s_old, 1.0), 0.0))
        died = (s_old > 0) & (s_new <= 0) & (reads > 0)
        born = (s_old <= 0) & (s_new > 0) & (reads > 0)
        term = jnp.where(both, reads * ratio,
                         jnp.where(died, -1e30, jnp.where(born, 1e30, 0.0)))
        return jnp.sum(term - eumaps * (s_new - s_old), axis=1)

    def block(state):
        th, s_prev, it, _ = state
        th = _pallas_block(m, eumaps, reads, inv_denom, th, block_iters,
                           tile_b)
        s_new = intens(th)
        return th, s_new, it + 1, jnp.max(gain_rows(s_prev, s_new))

    def cond(state):
        _, _, it, gain = state
        return (gain >= epsilon) & (it < max_blocks)

    state = (theta0, intens(theta0), jnp.int32(0),
             jnp.asarray(jnp.inf, theta0.dtype))
    th, _, it, _ = jax.lax.while_loop(cond, block, block(state))
    return th, it


def tile_for(C, T):
    return max(1, 4096 // (C * T))


def run_xla(batch, eps):
    B, C, T = batch.shape
    E = jnp.asarray(batch.eumaps)
    th, it = D._dense_solve_jax(jnp.asarray(batch.flat_idx), E,
                                jnp.asarray(batch.reads),
                                jnp.asarray(eps, E.dtype), B, C, T, 8, 2048)
    return jax.block_until_ready(th), it


def run_pallas(batch, eps):
    B, C, T = batch.shape
    tb = tile_for(C, T)
    Bp = -(-B // tb) * tb
    E = jnp.pad(jnp.asarray(batch.eumaps), ((0, Bp - B), (0, 0)))
    R = jnp.pad(jnp.asarray(batch.reads), ((0, Bp - B), (0, 0)))
    th, it = _dense_solve_pallas(jnp.asarray(batch.flat_idx), E, R,
                                 jnp.asarray(eps, E.dtype), Bp, C, T, 8,
                                 2048, tb)
    return jax.block_until_ready(th)[:B], it


def synth(C, T, B, rng):
    idx, E, R, tm = [], np.zeros((B, C), np.float32), \
        np.zeros((B, C), np.float32), np.full((B, T), -1, np.int32)
    for b in range(B):
        c = int(rng.integers(2, C + 1))
        t = int(rng.integers(1, T + 1))
        m = rng.random((c, t)) < 0.4
        m[np.arange(c), rng.integers(0, t, size=c)] = True
        ci, ti = np.nonzero(m)
        idx.append(b * C * T + ci * T + ti)
        E[b, :c] = rng.uniform(1, 10, size=c)
        th = rng.uniform(0, 5, size=t)
        R[b, :c] = rng.poisson(E[b, :c] * (m * th).sum(axis=1))
        tm[b, :t] = np.arange(t)
    return D.DenseBatch(shape=(B, C, T),
                        flat_idx=np.concatenate(idx).astype(np.int32),
                        eumaps=E, reads=R, tid_map=tm,
                        sids=np.arange(B, dtype=np.int64))


def loglik(batch, th):
    m = batch.m.astype(np.float64)
    lam = batch.eumaps.astype(np.float64) * np.einsum(
        "bct,bt->bc", m, np.asarray(th, np.float64))
    R = batch.reads.astype(np.float64)
    ok = lam > 0
    return float(np.sum(np.where(ok, R * np.log(np.where(ok, lam, 1.0))
                                 - lam, 0.0)))


def timeit(fn, reps):
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


def compare(batches, reps, label):
    tot_x = tot_p = 0.0
    for batch in batches:
        batch, _ = D._pad_b(batch)
        B, C, T = batch.shape
        t0 = time.perf_counter()
        thx, itx = run_xla(batch, 1e-5)
        cx = time.perf_counter() - t0
        mx, _ = timeit(lambda: run_xla(batch, 1e-5), reps)
        tot_x += mx
        try:
            t0 = time.perf_counter()
            thp, itp = run_pallas(batch, 1e-5)
            cp = time.perf_counter() - t0
            mp, _ = timeit(lambda: run_pallas(batch, 1e-5), reps)
            llx, llp = loglik(batch, thx), loglik(batch, thp)
            rel = abs(llp - llx) / max(abs(llx), float(batch.reads.sum()))
            tot_p += mp
            print(f"[{label}] class B={B} C={C} T={T}: xla {mx*1e3:.3f} ms "
                  f"({int(itx)} blocks, first call {cx:.2f} s) | pallas-triton "
                  f"tile_b={tile_for(C, T)} {mp*1e3:.3f} ms ({int(itp)} blocks, "
                  f"first call {cp:.2f} s) | loglik gap {rel:.2e} | per block: xla "
                  f"{mx/max(int(itx),1)*1e3:.3f} ms, pallas "
                  f"{mp/max(int(itp),1)*1e3:.3f} ms",
                  flush=True)
        except Exception as e:  # noqa: BLE001 - reported per class
            tot_p += mx
            msg = str(e).strip().splitlines()[0][:300] if str(e) else repr(e)
            print(f"[{label}] class B={B} C={C} T={T}: xla {mx*1e3:.3f} ms "
                  f"({int(itx)} blocks) | pallas-triton FAILED: "
                  f"{type(e).__name__}: {msg} (counted at the xla time)",
                  flush=True)
    print(f"[{label}] dense classes total: xla {tot_x*1e3:.3f} ms, "
          f"pallas-triton (xla where it failed) {tot_p*1e3:.3f} ms",
          flush=True)


def main():
    if ON_GPU:
        jax.config.update("jax_platforms", "cuda")
    jax.config.update("jax_enable_x64", True)
    print("devices:", jax.devices(), flush=True)
    mode = sys.argv[1]
    if mode == "check":
        rng = np.random.default_rng(0)
        compare([synth(C, T, 16, rng) for C, T in D.SIZE_CLASSES], 1,
                "check")
        return
    from emsar_jax.config import BuildConfig, QuantConfig
    from emsar_jax.index.build import build_se_index
    from emsar_jax.ingest.native import NativeCollapser
    from emsar_jax.io.fasta import read_fasta
    from emsar_jax.model.quantify import sample_problem
    from emsar_jax.utils import jitcache
    jitcache.enable()
    fa, reads = sys.argv[2], sys.argv[3]
    t0 = time.perf_counter()
    index = build_se_index(read_fasta(fa, "E"), 76, 76, BuildConfig(verbose=0))
    print(f"index built in {time.perf_counter() - t0:.1f} s", flush=True)
    cfg = QuantConfig(verbose=0)
    counts = NativeCollapser(index).collapse_file(
        reads, "bowtie", False, 0, 100, index.min_fraglength,
        index.max_fraglength, None)
    sp = sample_problem(index, counts, cfg)
    part = D.partition_modules(sp.graph, sp.modules, sp.eumaps,
                               sp.read_count, dtype=np.float32)
    print("batches:", [b.shape for b in part.batches],
          "csr modules:", len(part.csr_sids), flush=True)
    compare(part.batches, 5, "phase-a")


if __name__ == "__main__":
    main()

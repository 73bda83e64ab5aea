"""Batched reservoir-computing tests.

Oracle strategy: (a) ELL spmv and update vs dense numpy reference; (b) the
full train->predict pipeline must learn a chaotic system (batched Lorenz-63)
with closed-loop skill far beyond climatology — the classic ESN validation.
(c) domain pack/unpack roundtrips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from speedyml.reservoir.esn import (EsnParams, advance, nonlinear_state,
                                    readout, spmv_ell, synchronize,
                                    predict_step)
from speedyml.reservoir.generate import (generate_esn, spectral_radius_ell,
                                         radius_by_lat)
from speedyml.reservoir.training import (NormalEq, init_normal_eq,
                                         drive_and_accumulate, drive_discard,
                                         ridge_solve)
from speedyml.domain.decomposition import (build_layout, pack_global,
                                           gather_inputs, scatter_outputs)


class TestEsnCore:
    def test_spmv_matches_dense(self):
        rng = np.random.default_rng(0)
        R, n, deg = 3, 16, 4
        idx = rng.integers(0, n, (R, n, deg)).astype(np.int32)
        val = rng.normal(size=(R, n, deg))
        x = rng.normal(size=(R, n))
        dense = np.zeros((R, n, n))
        for r in range(R):
            for i in range(n):
                for d in range(deg):
                    dense[r, i, idx[r, i, d]] += val[r, i, d]
        want = np.einsum("rij,rj->ri", dense, x)
        got = np.asarray(spmv_ell(jnp.asarray(idx), jnp.asarray(val),
                                  jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_ring_fast_path_matches_generic(self):
        """The circulant-shift spmv (a_shift set) must equal the generic
        ELL gather on the same indices/values — the fast path is a pure
        execution-strategy change, not a numerics change."""
        from speedyml.reservoir.generate import make_ring_adjacency
        rng = np.random.default_rng(7)
        R, n, deg = 3, 24, 5
        idx, val, shifts = make_ring_adjacency(rng, R, n, deg)
        x = rng.normal(size=(R, n))
        generic = np.asarray(spmv_ell(jnp.asarray(idx), jnp.asarray(val),
                                      jnp.asarray(x)))
        fast = np.asarray(spmv_ell(jnp.asarray(idx), jnp.asarray(val),
                                   jnp.asarray(x), jnp.asarray(shifts)))
        np.testing.assert_allclose(fast, generic, rtol=1e-6)
        # and through advance() on full params, under jit
        p = generate_esn(seed=3, R=R, n_in=4, n_out=2, n_model=0,
                         m_target=n, deg=deg, topology="ring")
        assert p.a_shift is not None
        u = jnp.asarray(rng.normal(size=(R, 4)))
        x0 = jnp.asarray(rng.normal(size=(R, p.n)))
        y_fast = np.asarray(jax.jit(advance)(p, x0, u))
        y_gen = np.asarray(jax.jit(advance)(p._replace(a_shift=None), x0, u))
        np.testing.assert_allclose(y_fast, y_gen, rtol=1e-6, atol=1e-6)

    def test_bf16_wout_readout_close(self):
        """bf16-stored wout (f32 accumulation) must track the f32 readout to
        ~bf16 rounding — the documented fast-path acceptance bound."""
        from speedyml.reservoir.esn import cast_wout
        rng = np.random.default_rng(11)
        p = generate_esn(seed=5, R=2, n_in=6, n_out=4, n_model=4,
                         m_target=600, deg=6)
        p = p._replace(wout=jnp.asarray(
            rng.normal(size=p.wout.shape) * 0.1, jnp.float32))
        x = jnp.asarray(rng.normal(size=(2, p.n)), jnp.float32)
        mv = jnp.asarray(rng.normal(size=(2, 4)), jnp.float32)
        full = np.asarray(readout(p, x, mv))
        fast = np.asarray(readout(cast_wout(p), x, mv))
        assert fast.dtype == np.float32
        scale = np.abs(full).mean()
        assert np.abs(fast - full).max() < 0.02 * max(scale, 1.0)

    def test_shift_detection_roundtrip(self):
        """shifts_from_ell recovers circulant structure from a persisted ELL
        index array and rejects random (ER) support."""
        from speedyml.reservoir.generate import (make_ring_adjacency,
                                                 make_ell_adjacency,
                                                 shifts_from_ell, ring_shifts)
        rng = np.random.default_rng(9)
        idx, _, shifts = make_ring_adjacency(rng, R=4, n=32, deg=6)
        got = shifts_from_ell(idx)
        assert got is not None
        np.testing.assert_array_equal(np.sort(got), np.sort(shifts))
        np.testing.assert_array_equal(shifts, ring_shifts(32, 6))
        idx_er, _ = make_ell_adjacency(rng, R=4, n=32, deg=6)
        assert shifts_from_ell(idx_er) is None

    def test_spectral_radius_power_iteration(self):
        rng = np.random.default_rng(1)
        R, n, deg = 2, 40, 5
        idx = rng.integers(0, n, (R, n, deg)).astype(np.int32)
        val = rng.uniform(0, 1, (R, n, deg))
        lam = spectral_radius_ell(idx, val, iters=500)
        for r in range(R):
            dense = np.zeros((n, n))
            for i in range(n):
                for d in range(deg):
                    dense[i, idx[r, i, d]] += val[r, i, d]
            want = np.abs(np.linalg.eigvals(dense)).max()
            np.testing.assert_allclose(lam[r], want, rtol=1e-6)

    def test_spectral_radius_ring_rolls_match_gather(self):
        """The circulant power iteration (rolls) equals the generic gather
        on the same ring adjacency."""
        from speedyml.reservoir.generate import make_ring_adjacency
        rng = np.random.default_rng(4)
        idx, val, shifts = make_ring_adjacency(rng, 3, 57, 6)
        np.testing.assert_allclose(
            spectral_radius_ell(idx, val, shifts=shifts),
            spectral_radius_ell(idx, val), rtol=1e-12)

    def test_radius_by_lat(self):
        r = radius_by_lat(np.array([-80.0, 10.0]), np.array([-70.0, 12.0]))
        assert r[0] == 0.7
        assert abs(r[1] - (0.4 / 45.0 + 0.3)) < 1e-12

    def test_nonlinear_state_squares_odd(self):
        x = jnp.asarray(np.arange(1.0, 7.0)[None])
        xt = np.asarray(nonlinear_state(x))[0]
        np.testing.assert_allclose(xt, [1, 4, 3, 16, 5, 36])

    def test_win_block_structure(self):
        p = generate_esn(seed=0, R=2, n_in=5, n_out=3, n_model=0,
                         m_target=20, deg=3, sigma=0.5)
        assert p.q == 4 and p.n == 20
        # advancing with a one-hot input only excites the matching block
        x0 = jnp.zeros((2, 20))
        u = jnp.zeros((2, 5)).at[:, 2].set(1.0)
        x1 = np.asarray(advance(p, x0, u))
        nz = np.nonzero(x1[0])[0]
        assert set(nz).issubset(set(range(2 * 4, 3 * 4)))


def lorenz63_series(T, R, dt=0.02, seed=0):
    """R independent Lorenz-63 trajectories, (T, R, 3), standardized."""
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(R, 3)) * 5 + np.array([0, 0, 25.0])
    out = np.empty((T, R, 3))
    def f(s):
        x, y, z = s[:, 0], s[:, 1], s[:, 2]
        return np.stack([10 * (y - x), x * (28 - z) - y,
                         x * y - 8.0 / 3.0 * z], 1)
    for _ in range(200):  # spin onto attractor
        for _ in range(5):
            k1 = f(s); k2 = f(s + 0.5*dt*k1); k3 = f(s + 0.5*dt*k2)
            k4 = f(s + dt*k3)
            s = s + dt/6*(k1 + 2*k2 + 2*k3 + k4)
    for t in range(T):
        k1 = f(s); k2 = f(s + 0.5*dt*k1); k3 = f(s + 0.5*dt*k2)
        k4 = f(s + dt*k3)
        s = s + dt/6*(k1 + 2*k2 + 2*k3 + k4)
        out[t] = s
    mean = out.mean(axis=(0,)); std = out.std(axis=(0,))
    return (out - mean) / std


class TestTrainPredict:
    def test_lorenz_closed_loop_skill(self):
        """Train R=4 reservoirs on Lorenz-63; closed-loop forecast must track
        the truth for >1 Lyapunov time (NRMSE < 0.5 over 50 steps) and the
        one-step error must be tiny."""
        R, n_in, n_out = 4, 3, 3
        T_train, T_sync, T_pred = 8000, 100, 50
        data = lorenz63_series(T_train + T_sync + T_pred + 1, R, seed=3)

        # reference-like regularization (beta_res=1e-3, multiplicative input
        # noise; mod_reservoir.f90:95-97 + set_reservoir_by_region) keeps the
        # compensated-f32 normal equations well conditioned
        params = generate_esn(seed=1, R=R, n_in=n_in, n_out=n_out, n_model=0,
                              m_target=300, deg=6, sigma=0.5,
                              radii=np.full(R, 0.9))
        acc = init_normal_eq(params, n_out)
        key = jax.random.PRNGKey(0)
        x = drive_discard(params, acc.x, jnp.asarray(data[:100]),
                          noise_mag=0.02, rng_key=key)
        acc = acc._replace(x=x)
        inputs = jnp.asarray(data[100:T_train])
        targets = jnp.asarray(data[101:T_train + 1])
        acc = drive_and_accumulate(params, acc, inputs, targets,
                                   noise_mag=0.02, rng_key=key)
        wout = ridge_solve(acc, n_model=0, beta_res=1e-3, beta_model=1.0)
        params = params._replace(wout=jnp.asarray(wout, jnp.float32))

        # synchronize on truth, then free-run
        x = jnp.zeros((R, params.n))
        x = synchronize(params, x,
                        jnp.asarray(data[T_train:T_train + T_sync]))

        # one-step error
        x1, out1 = predict_step(params, x,
                                jnp.asarray(data[T_train + T_sync - 1]))
        # note: x was already driven through that input; use fresh readout
        pred1 = np.asarray(readout(params, x))
        err1 = np.abs(pred1 - data[T_train + T_sync]).mean()
        assert err1 < 0.1, f"one-step error too large: {err1}"

        # closed loop
        preds = []
        fb = jnp.asarray(pred1)
        for t in range(T_pred):
            x, out = predict_step(params, x, fb)
            preds.append(np.asarray(out))
            fb = out
        preds = np.stack(preds)
        truth = data[T_train + T_sync + 1: T_train + T_sync + 1 + T_pred]
        nrmse = np.sqrt(((preds - truth) ** 2).mean())
        assert nrmse < 0.5, f"closed-loop NRMSE {nrmse}"

    def test_hybrid_aug_layout(self):
        """Hybrid readout concatenates [model; x~] (mod_reservoir.f90:1446)."""
        p = generate_esn(seed=2, R=1, n_in=4, n_out=2, n_model=2, m_target=8,
                         deg=2)
        na = p.n + 2
        wout = np.zeros((1, 2, na))
        wout[0, 0, 0] = 1.0    # reads model_vec[0]
        wout[0, 1, 2] = 1.0    # reads x~[0]
        p = p._replace(wout=jnp.asarray(wout, jnp.float32))
        x = jnp.ones((1, p.n))
        out = np.asarray(readout(p, x, model_vec=jnp.asarray([[7.0, 8.0]])))
        assert out[0, 0] == 7.0
        assert out[0, 1] == 1.0


class TestDomain:
    @pytest.fixture(scope="class")
    def layout(self):
        return build_layout()

    def test_geometry(self, layout):
        assert layout.R == 1152
        assert layout.n_in == 576          # SURVEY.md: 4*4*4*8 + 4*16
        assert layout.n_out == 136         # 4*2*2*8 + 4 + 4

    def test_scatter_gather_roundtrip(self, layout):
        """outputs scattered to the globe, re-gathered as the core part of
        the inputs, must match."""
        rng = np.random.default_rng(0)
        L = layout
        atmo = rng.normal(size=(L.nvars, L.kx, L.il, L.ix))
        logp = rng.normal(size=(L.il, L.ix))
        precip = rng.normal(size=(L.il, L.ix))
        sst = rng.normal(size=(L.il, L.ix))
        tisr = rng.normal(size=(L.il, L.ix))
        gv = pack_global(L, jnp.asarray(atmo), jnp.asarray(logp),
                         jnp.asarray(precip), jnp.asarray(sst),
                         jnp.asarray(tisr))
        inp = np.asarray(gather_inputs(L, gv))
        assert inp.shape == (L.R, L.n_in)

        # core of region (ry=5, rx=7): input patch interior == global values
        r = 5 * L.nregx + 7
        s0, _ = L.sizes["atmo3d"]
        v, z, yy, xx = 2, 3, 1, 2   # interior of the 4x4 patch (core cell)
        pos = s0 + v + L.nvars * (xx + L.inpx * (yy + L.inpy * z))
        gy = 5 * L.resy + (yy - L.overlap)
        gx = 7 * L.resx + (xx - L.overlap)
        assert inp[r, pos] == atmo[v, z, gy, gx]

        # scatter: build outvec from the true core values, re-assemble globe
        out = np.empty((L.R, L.n_out))
        for rr in range(L.R):
            ry, rx = divmod(rr, L.nregx)
            ys = slice(ry * L.resy, (ry + 1) * L.resy)
            xs = slice(rx * L.resx, (rx + 1) * L.resx)
            core = atmo[:, :, ys, xs]                      # (v, kx, resy, resx)
            sec = core.transpose(1, 2, 3, 0).ravel()       # (z,y,x,v) v fastest
            out[rr, :sec.size] = sec
            o0, o1 = L.out_sizes["logp"]
            out[rr, o0:o1] = logp[ys, xs].ravel()
            o0, o1 = L.out_sizes["precip"]
            out[rr, o0:o1] = precip[ys, xs].ravel()
        atmo2, logp2, precip2 = scatter_outputs(L, jnp.asarray(out))
        np.testing.assert_allclose(np.asarray(atmo2), atmo)
        np.testing.assert_allclose(np.asarray(logp2), logp)
        np.testing.assert_allclose(np.asarray(precip2), precip)

    def test_periodic_and_pole_halo(self, layout):
        """x wraps periodically; y clamps at the poles."""
        L = layout
        rng = np.random.default_rng(1)
        logp = rng.normal(size=(L.il, L.ix))
        zeros3 = jnp.zeros((L.nvars, L.kx, L.il, L.ix))
        z2 = jnp.zeros((L.il, L.ix))
        gv = pack_global(L, zeros3, jnp.asarray(logp), z2, z2, z2)
        inp = np.asarray(gather_inputs(L, gv))
        s0, _ = L.sizes["logp"]
        # region at rx=0: its western halo column is global x = ix-1
        r = 5 * L.nregx + 0
        patch = inp[r, s0:s0 + L.inpy * L.inpx].reshape(L.inpy, L.inpx)
        gy0 = 5 * L.resy - L.overlap
        np.testing.assert_allclose(patch[1, 0], logp[gy0 + 1, L.ix - 1])
        # southernmost region row: halo clamps to row 0
        r = 0
        patch = inp[r, s0:s0 + L.inpy * L.inpx].reshape(L.inpy, L.inpx)
        np.testing.assert_allclose(patch[0, 1:3], logp[0, 0:2])


class TestRidgeSolvers:
    def _random_acc(self, seed, R=3, na=40, n_out=5, T=60):
        """NormalEq with a realistic hi/lo split from actual accumulation."""
        rng = np.random.default_rng(seed)
        aug = rng.normal(size=(T, R, na)).astype(np.float32)
        y = rng.normal(size=(T, R, n_out)).astype(np.float32)
        from speedyml.reservoir.training import _two_sum
        hi = jnp.zeros((R, na, na)); lo = jnp.zeros_like(hi)
        shi = jnp.zeros((R, n_out, na)); slo = jnp.zeros_like(shi)
        for t0 in range(0, T, 20):
            a = jnp.asarray(aug[t0:t0 + 20])
            hi, lo = _two_sum(hi, lo, jnp.einsum("tra,trb->rab", a, a))
            shi, slo = _two_sum(shi, slo, jnp.einsum(
                "tro,tra->roa", jnp.asarray(y[t0:t0 + 20]), a))
        return NormalEq(ss_hi=hi, ss_lo=lo, sy_hi=shi, sy_lo=slo,
                        x=jnp.zeros((R, 4)))

    @pytest.mark.parametrize("n_model,prior", [(0, 0.0), (5, 0.0), (5, 0.7)])
    def test_device_solver_matches_host(self, n_model, prior):
        """ridge_solve_device (on-device f64 Cholesky, which keeps the
        normal equations on the device) must agree with the host f64 LU
        solve."""
        from speedyml.reservoir.training import ridge_solve, ridge_solve_device
        acc = self._random_acc(0)
        kw = dict(n_model=n_model, beta_res=1e-3, beta_model=1.0,
                  prior_val=prior, use_prior=prior != 0.0)
        w_host = ridge_solve(acc, **kw)
        w_dev = np.asarray(ridge_solve_device(acc, **kw), np.float64)
        np.testing.assert_allclose(w_dev, w_host, rtol=2e-5, atol=2e-5)

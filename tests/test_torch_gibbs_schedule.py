"""The schedules of the Gibbs-sweep kernels G1 and G2 (csrc/gibbs.cu), on
the CPU, through their plain mirrors in ops/kernels.py:

- G2 runs a pre-pass over every block from the state carried into the
  sweep (Cb = G1 + diag(σe²/var_b) + 1e-4 I, L = chol(Cb), X = L⁻¹, M =
  Cb⁻¹ = XᵀX, w = Xᵀ(X G1 b_old + √σe² z)), then a serial pass that draws
  b = M (Z1 r) + w per block (``gibbs_sweep_block_mvn_hoisted_plain``);
- G1 forms every block's chain constants first and runs the chain with
  products by them in place of the reference's divisions, logs and
  sigmoid (``gibbs_sweep_marker_hoisted_plain``).

Each is held, on seeded numpy inputs, against the existing plain version
(the reference's form) for one sweep from the same state and draws: δ
identical; β, var_b and r within rtol 1e-4 (G1) and 1e-3 (G2), with floors
of the same share of each one's largest value (the card's bounds for the
kernels, tests/test_torch_cuda.py). G2's pre-pass against
torch.cholesky_inverse within 1e-5 of each block's largest entry (f32
inverses of a well-conditioned Cb). And the port's chains, whose CPU path
runs these mirrors, follow the reference's ``_gibbs`` and
``_gibbs_blocked_a`` with its own replayed draws (the seam of
tests/test_torch_bayes.py) over 12 iterations: the (μ, σe²) trace and the
posterior-mean effects within rtol 1e-4 (atol 1e-6 on the effects).
Cases: a ragged last block (m = 250 in blocks of 128), C < 128 (blocks of
64 and a single block of 40), BayesB, BayesCπ and BayesA.
"""

import numpy as np
import pytest
import torch

from janusx_tpu.gs import bayes as jb
from janusx_tpu_torch.gs import bayes as tb
from janusx_tpu_torch.ops import kernels
from test_torch_bayes import ReplayDraws, _panel

SHAPES = [(120, 250, 128), (90, 300, 64), (60, 40, 128)]  # (n, m, block)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Loops of tiny torch ops: one torch thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sweep_inputs(n, m, block, seed, method):
    """One sweep's operands as gs/bayes.py builds them, from a seeded
    panel, at a mid-chain state: nonzero effects on about half of the
    markers, per-marker slab variances around the prior's, the intercept
    removed from r."""
    Z, y = _panel(n, m, seed)
    Zb, Gb, x2 = tb.block_markers(torch.as_tensor(Z), block)
    nb, C, _ = Zb.shape
    rng = np.random.default_rng(seed + 1)
    beta = torch.as_tensor(rng.normal(0, 0.05, (nb, C)) * (rng.uniform(size=(nb, C)) < 0.5),
                           dtype=torch.float32) * (x2 > 0)
    var_y = float(np.var(y, ddof=1))
    s0_b = var_y * 0.5 / float(x2.sum() / n) * 7.0 / (1.0 if method == "A" else 0.5)
    var_b = torch.as_tensor(s0_b / 7.0 * rng.uniform(0.5, 2.0, (nb, C)), dtype=torch.float32)
    r = torch.as_tensor(y - y.mean(), dtype=torch.float32) - (beta.reshape(-1) @ Zb.reshape(
        nb * C, n))
    scal = torch.tensor([0.5 * var_y, s0_b / 7.0, 0.4, s0_b, s0_b / 7.0], dtype=torch.float32)
    g = torch.Generator().manual_seed(seed)
    rn, ru = torch.randn((nb, C), generator=g), torch.rand((nb, C), generator=g)
    rca = 2.0 * torch._standard_gamma(torch.full((nb, C), 3.0), generator=g)
    rci = 2.0 * torch._standard_gamma(torch.full((nb, C), 2.5), generator=g)
    return Zb, Gb, x2, [beta, var_b, r], scal, (rn, ru, rca, rci)


def _close(got, want, rtol, what):
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * float(want.abs().max()),
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("method", ["B", "Cpi"])
@pytest.mark.parametrize("n,m,block", SHAPES)
def test_marker_schedule_matches_plain(method, n, m, block):
    """G1's constants-first chain against the reference-form plain sweep:
    δ identical, β / var_b / r within rtol 1e-4."""
    Zb, Gb, x2, state, scal, (rn, ru, rca, rci) = _sweep_inputs(n, m, block, m + block, "B")
    out = {}
    for name, fn in (("hoisted", kernels.gibbs_sweep_marker_hoisted_plain),
                     ("plain", kernels.gibbs_sweep_marker_plain)):
        st = [t.clone() for t in state]
        d = fn(Zb, Gb, x2, st[0], st[1], rn, ru, rca, rci, st[2], scal, method)
        out[name] = (d, st)
    assert torch.equal(out["hoisted"][0], out["plain"][0])
    assert 0 < int(out["plain"][0].sum()) < out["plain"][0].numel()
    for what, got, want in zip(("beta", "var_b", "r"), out["hoisted"][1], out["plain"][1]):
        _close(got, want, 1e-4, what)
    if method == "Cpi":  # var_b is dead state in BayesCπ
        assert torch.equal(out["hoisted"][1][1], state[1])


@pytest.mark.parametrize("n,m,block", SHAPES)
def test_mvn_schedule_matches_plain(n, m, block):
    """G2's pre-pass + serial pass against the reference-form plain sweep
    (a Cholesky and three triangular solves per block): β / var_b / r
    within rtol 1e-3."""
    Zb, Gb, x2, state, scal, (z, _, rchi, _) = _sweep_inputs(n, m, block, m + block, "A")
    out = {}
    for name, fn in (("hoisted", kernels.gibbs_sweep_block_mvn_hoisted_plain),
                     ("plain", kernels.gibbs_sweep_block_mvn_plain)):
        st = [t.clone() for t in state]
        fn(Zb, Gb, x2, st[0], st[1], z, rchi, st[2], scal)
        out[name] = st
    for what, got, want in zip(("beta", "var_b", "r"), out["hoisted"], out["plain"]):
        _close(got, want, 1e-3, what)
    assert torch.equal(out["hoisted"][0][x2 == 0], torch.zeros(int((x2 == 0).sum())))


@pytest.mark.parametrize("n,m,block", SHAPES)
def test_mvn_prepass_matches_linalg(n, m, block):
    """The pre-pass's M against torch.cholesky_inverse(cholesky(Cb)) within
    1e-5 of each block's largest entry, and M (Z1 r) + w against the
    reference's mean L⁻ᵀL⁻¹(Z1 r + G1 b_old) plus noise √σe² L⁻ᵀ z (rtol
    1e-4), block by block from the same r."""
    Zb, Gb, x2, (beta, var_b, r), scal, (z, _, _, _) = _sweep_inputs(n, m, block, m, "A")
    M, w = kernels.gibbs_block_mvn_prepass_plain(Gb, x2, beta, var_b, z, scal)
    C = Gb.shape[1]
    dinv = torch.where(x2 > 0, scal[0] / var_b.clamp_min(1e-12), 1.0)
    L = torch.linalg.cholesky(Gb + torch.diag_embed(dinv) + 1e-4 * torch.eye(C))
    want = torch.cholesky_inverse(L)
    for b in range(Gb.shape[0]):
        err = float((M[b] - want[b]).abs().max())
        assert err <= 1e-5 * float(want[b].abs().max()), f"block {b}: M off by {err:.3g}"
        rhs = Zb[b] @ r + Gb[b] @ beta[b]
        ref = (torch.linalg.solve_triangular(
            L[b].T, torch.linalg.solve_triangular(L[b], rhs[:, None], upper=False), upper=True)
            + torch.sqrt(scal[0]) * torch.linalg.solve_triangular(L[b].T, z[b][:, None],
                                                                  upper=True))[:, 0]
        _close(M[b] @ (Zb[b] @ r) + w[b], ref, 1e-4, f"block {b} draw")


@pytest.mark.parametrize("method", ["BayesA", "BayesB", "BayesCpi"])
@pytest.mark.parametrize("n,m,block", SHAPES[:2])
def test_schedules_follow_reference_with_replayed_draws(monkeypatch, method, n, m, block):
    """The port's chain on the CPU, every sweep through the schedule's
    mirror (counted), against the reference's chain with the same
    jax.random draws: trace and posterior means within rtol 1e-4."""
    calls = []
    for name in ("gibbs_sweep_marker_hoisted_plain", "gibbs_sweep_block_mvn_hoisted_plain"):
        fn = getattr(kernels, name)
        monkeypatch.setattr(kernels, name,
                            lambda *a, _fn=fn, **k: calls.append(1) or _fn(*a, **k))
    Z, y = _panel(n, m, seed=block)
    kw = dict(n_iter=12, burnin=4, seed=7, block=block, return_trace=True)
    bj, mj, trj = jb.bayes_fit(Z, y, method, **kw)
    bt, mt, trt = tb.bayes_fit(Z, y, method, device="cpu", _draws=ReplayDraws(7), **kw)
    assert len(calls) == 12
    np.testing.assert_allclose(trt, trj, rtol=1e-4)
    assert mt == pytest.approx(mj, rel=1e-4)
    np.testing.assert_allclose(bt, bj, rtol=1e-4, atol=1e-6)

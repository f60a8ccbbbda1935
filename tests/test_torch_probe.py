'''P1 and P2 (the A/B tool's round-2 batch step and the deletion probe's
variants) on the CPU: the port's plain versions against the JAX tools'
Pallas bodies, run in interpret mode.

The tools' ``pallas_call``s take no interpret flag, so each test swaps
the tool module's ``pl`` for a shim whose ``pallas_call`` adds
``interpret=True``; ``kernel_probe``'s batch and chunk are module
globals (its window is always ``kernel_probe.W`` = 128 rows).  Nothing
under ``tools/`` changes.

Tolerances: K1's (``chip_smoke.py``: window atol 5e-3 + rtol 5e-2, SSE
rtol 1e-3), and each entry's change within 1 % of the largest change
(``UPD_TOL``): the no_acc variants only shrink the window, by less than
K1's atol.  Port and Pallas body round to bf16 at the same places; f32
sums in another order can flip one bf16 rounding of the window read for
a sweep.'''
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental import pallas as jax_pl

from mfrec_tpu_torch.ops import half_pass_old_kernel as p1
from mfrec_tpu_torch.ops import probe_kernel as p2
from mfrec_tpu_torch.ops import sgd_mf
from tools import ab_kernel, kernel_probe

# the suite runs in several xdist workers: one intra-op thread each
torch.set_num_threads(1)

ATOL, RTOL, SSE_RTOL = 5e-3, 5e-2, 1e-3
UPD_TOL = 1e-2


def _interpret_shim():
    def pallas_call(*args, **kwargs):
        kwargs['interpret'] = True
        return jax_pl.pallas_call(*args, **kwargs)
    return types.SimpleNamespace(
        pallas_call=pallas_call, program_id=jax_pl.program_id,
        num_programs=jax_pl.num_programs, when=jax_pl.when, ds=jax_pl.ds,
        BlockSpec=jax_pl.BlockSpec)


@pytest.fixture
def interpret(monkeypatch):
    shim = _interpret_shim()
    monkeypatch.setattr(kernel_probe, 'pl', shim)
    monkeypatch.setattr(ab_kernel, 'pl', shim)


def _close(got, want, sse, sse_want, window):
    got, want, window = (np.asarray(x, np.float64)
                         for x in (got, want, window))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    moved = np.abs(want - window).max()
    assert moved > 0
    np.testing.assert_allclose(got - window, want - window,
                               atol=UPD_TOL * moved, rtol=0)
    assert abs(float(sse) - float(sse_want)) <= \
        SSE_RTOL * max(abs(float(sse_want)), 1e-6)


def _probe_inputs(k, B, W=128, seed=0):
    rng = np.random.default_rng(seed + k)
    m = np.ones(B, np.float32)
    m[rng.random(B) < 0.15] = 0.0
    return (rng.normal(0, 0.3, (W, k)).astype(np.float32),
            rng.normal(0, 0.3, (B, k)).astype(np.float32),
            rng.uniform(1, 5, B).astype(np.float32), m,
            np.sort(rng.integers(0, W, B)).astype(np.int32),
            np.full(k, 0.1, np.float32), np.full(k, 0.02, np.float32))


@pytest.mark.parametrize('k', [8, 66])
@pytest.mark.parametrize('variant', sorted(p2.VARIANTS))
def test_probe_ref_matches_pallas(interpret, monkeypatch, variant, k):
    '''All 17 variants: ``probe_step_ref`` against ``run_one`` (B=256,
    CH=128; the 2D path's chunk passed as 128 too), some m = 0.'''
    B, CH, T = 256, 128, 2
    monkeypatch.setattr(kernel_probe, 'B', B)
    monkeypatch.setattr(kernel_probe, 'CH', CH)
    data = _probe_inputs(k, B)
    want, sse_w = kernel_probe.run_one(*map(jnp.asarray, data), variant, T,
                                       k, ch=CH)
    got, sse = p2.probe_step_ref(*map(torch.from_numpy, data), variant, T,
                                 CH)
    _close(got, want, sse, sse_w, data[0])
    # the chained wrapper on CPU tensors: the plain version, no launch
    before = p2.probe_chain.launches
    out, sse2 = p2.probe_chain(*map(torch.from_numpy, data), variant, T,
                               n_chain=1, ch=CH)
    assert p2.probe_chain.launches == before
    assert torch.equal(out, got) and float(sse2) == float(sse)


def test_probe_chain_and_problems():
    '''A chain of calls is the calls in turn; G problems are G chains.'''
    t = torch.from_numpy
    a = _probe_inputs(8, 256, seed=1)
    b = _probe_inputs(8, 256, seed=2)
    win = t(a[0])
    sse = 0.0
    for _ in range(3):
        win, s = p2.probe_step_ref(win, *map(t, a[1:]), 'all2d_no_acc', 2,
                                   128)
        sse += float(s)
    both = [torch.stack([t(x), t(y)]) for x, y in zip(a[:5], b[:5])]
    out, sse_g = p2.probe_chain(*both, t(a[5]), t(a[6]), 'all2d_no_acc', 2,
                                n_chain=3, ch=128)
    torch.testing.assert_close(out[0], win, atol=0, rtol=0)
    other, sse_b = p2.probe_chain(*map(t, b), 'all2d_no_acc', 2, n_chain=3,
                                  ch=128)
    torch.testing.assert_close(out[1], other, atol=0, rtol=0)
    assert float(sse_g) == pytest.approx(sse + float(sse_b), rel=1e-6)


@pytest.mark.parametrize('G', [0, 1, 2])
def test_probe_tables_group_entries_by_row(G):
    '''The kernel's entry table: each row's entries, in batch order, as
    flat indices into the G*B entries (G=0: one problem of shape [B]);
    rows with no entry get an empty range.'''
    rng = np.random.default_rng(4 + G)
    W, B = 16, 64
    kl = np.sort(rng.integers(0, W - 2, (max(G, 1), B)), axis=1).astype(
        np.int32)
    tab = p2.probe_tables(torch.from_numpy(kl if G else kl[0]), W)
    assert (tab.G, tab.W, tab.B) == (max(G, 1), W, B)
    ptr = tab.seg_ptr.numpy()
    ent = tab.ent.numpy()
    assert ptr[0] == 0 and ptr[-1] == max(G, 1) * B
    for x in range(max(G, 1) * W):
        g, w = divmod(x, W)
        idx = ent[ptr[x]:ptr[x + 1]]
        assert (idx // B == g).all() and (kl[g, idx % B] == w).all()
        assert (np.diff(idx) > 0).all()
        assert len(idx) == int((kl[g] == w).sum())


@pytest.mark.parametrize('variant', ['no_acc', 'all2d_no_acc'])
def test_no_acc_is_the_shrink_at_the_probe_shape(variant):
    '''What the kernel leaves out of the no_acc variants: at the probe's
    shape (B=16,384, W=128, k=66, T=10) the Pallas bodies' keep-alive term
    (~1e-9 a sweep) moves no window entry by more than 2e-7, a few f32
    steps of an entry of 0.3: the window is the regularization shrink
    alone (the kernel's order of operations) to rounding, and that shrink
    moves it by 1e5 times more.'''
    from mfrec_tpu_torch.tools import kernel_probe as kp
    window, ff, r, m, kl, lrv, regv = kp.probe_data('cpu', ks=(66,))[66]
    got, _ = p2.probe_step_ref(window, ff, r, m, kl, lrv, regv, variant, 10,
                               kp.CH)
    alive = (torch.bincount(kl.long(), minlength=kp.W) > 0).float()[:, None]
    win = window.clone()
    for _ in range(10):
        win = win + lrv * (0.0 - regv * win * alive)
    assert float((got - win).abs().max()) <= 2e-7
    assert float((win - window).abs().max()) > 1e-2


def test_probe_full_takes_bf16_fixed_rows():
    ''''full' on bf16 fixed rows (K1's storage) is 'full' on those rows'
    f32 values; the other functions refuse them.'''
    t = torch.from_numpy
    window, ff, *rest = map(t, _probe_inputs(8, 256))
    ff16 = ff.to(torch.bfloat16)
    got = p2.probe_chain(window, ff16, *rest, 'full', 2, n_chain=2, ch=128)
    want = p2.probe_chain(window, ff16.float(), *rest, 'full', 2, n_chain=2,
                          ch=128)
    assert torch.equal(got[0], want[0]) and float(got[1]) == float(want[1])
    for variant in ('all2d', 'no_acc', 'bf16_chain'):
        with pytest.raises(ValueError):
            p2.probe_chain(window, ff16, *rest, variant, 2, ch=128)


def test_probe_refusals():
    t = torch.from_numpy
    data = list(map(t, _probe_inputs(8, 256)))
    with pytest.raises(ValueError):                   # unknown variant
        p2.probe_chain(*data, 'no_such', 2)
    with pytest.raises(ValueError):                   # ragged chunk
        p2.probe_chain(*data, 'full', 2, ch=100)
    with pytest.raises(ValueError):                   # chunk below W
        p2.probe_chain(*data, 'no_acc', 2, ch=64)
    with pytest.raises(ValueError):                   # k above 128
        p2.probe_chain(torch.zeros(128, 130), torch.zeros(256, 130),
                       *data[2:5], torch.zeros(130), torch.zeros(130),
                       'full', 2)
    with pytest.raises(ValueError):                   # kl outside W
        p2.probe_tables(t(np.full(256, 128, np.int32)), 128)


def _old_batch(k, seed, B=256, W=16):
    rng = np.random.default_rng(seed)
    win = rng.normal(0, 0.3, (W, k)).astype(np.float32)
    ff = torch.from_numpy(rng.normal(0, 0.3, (B, k)).astype(
        np.float32)).to(torch.bfloat16)
    r = rng.uniform(1, 5, B).astype(np.float32)
    m = (rng.random(B) > 0.2).astype(np.float32)
    kl = np.sort(rng.integers(0, W - 3, B)).astype(np.int32)   # 3 rows empty
    lrv = np.full(k, 0.15, np.float32)
    lrv[-1] = 0.0
    regv = np.full(k, 0.02, np.float32)
    return win, ff, r, m, kl, lrv, regv


@pytest.mark.parametrize('T', [1, 3])
@pytest.mark.parametrize('k', [8, 66, 130])
def test_old_batch_ref_matches_pallas(interpret, k, T):
    '''P1's plain version against ``half_pass_batch_old`` (W=16, chunk
    64): empty rows keep their values, masked entries add nothing.'''
    W = 16
    win, ff, r, m, kl, lrv, regv = _old_batch(k, seed=k + T, W=W)
    ffj = jnp.asarray(ff.float().numpy()).astype(jnp.bfloat16)
    want, sse_w = ab_kernel.half_pass_batch_old(
        jnp.asarray(win), ffj, jnp.asarray(r), jnp.asarray(m),
        jnp.asarray(kl), jnp.asarray(lrv), jnp.asarray(regv), 3.4, W, 64, T)
    t = torch.from_numpy
    got, sse = p1.half_pass_batch_old(t(win), ff, t(r), t(m), t(kl), t(lrv),
                                      t(regv), 3.4, W, 64, T)
    _close(got, want, sse, sse_w, win)
    np.testing.assert_array_equal(got.numpy()[W - 3:], win[W - 3:])
    np.testing.assert_array_equal(got.numpy()[:, -1], win[:, -1])


def test_old_step_is_not_the_xla_branch_step():
    """P1 reads the window in bf16; the port's XLA-branch batch step
    (``make_alternating_epoch(use_kernel=False)``, whose P half-pass
    leaves P as its Q half-pass finds it) reads it in f32.  From a
    bf16-exact window one sweep of each is the same; from any other
    window, or after a sweep, they part by more than float noise."""
    W, k, B = 8, 6, 512
    rng = np.random.default_rng(0)
    u = np.sort(rng.integers(0, W, B)).astype(np.int32)
    i = rng.integers(0, 20, B).astype(np.int32)
    v = rng.uniform(1, 5, B).astype(np.float32)
    lay = {a: sgd_mf.sorted_pass_layout(u, i, v, B, axis=a, max_window=W)
           for a in ('user', 'item')}
    pl_, ql_ = (sgd_mf.PassLayout(lay[a], a, 'cpu') for a in ('user', 'item'))
    P = rng.normal(0, 0.3, (W + W, k)).astype(np.float32)
    Q = torch.from_numpy(rng.normal(0, 0.3, (20 + W, k)).astype(np.float32))
    lrv, regv = (torch.from_numpy(a) for a in sgd_mf.column_rates(
        k - 2, True, 0.15, 0.02, 0.02))
    for P0, T, same in ((torch.from_numpy(P).to(torch.bfloat16).float(), 1,
                         True), (torch.from_numpy(P), 1, False),
                        (torch.from_numpy(P).to(torch.bfloat16).float(), 4,
                         False)):
        ep = sgd_mf.make_alternating_epoch(W, W, 0.15, 0.02, inner_steps=T)
        xla, _, _ = ep(P0.clone(), Q.clone(), 3.4, pl_, ql_)
        old = P0.clone()
        p1.half_pass_old(old, Q, pl_.batches(), W, lrv, regv, 3.4, T)
        diff = float((old - xla).abs().max())
        torch.testing.assert_close(old, xla, atol=ATOL, rtol=RTOL)
        assert (diff <= 1e-6) if same else (diff > 1e-6), (T, diff)

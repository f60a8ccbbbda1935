'''K1f (the half-pass in which one column moves: FN's user side, which
trains b_u alone) on the CPU: its plain version against K1's plain
version run with FN's frozen rates, the wrapper's CPU branch, how K1f
splits a segment table, and the epoch's routing.

Numerics held to, by test:
- ``frozen_half_pass_ref`` vs ``half_pass_ref`` with
  ``column_rates(..., freeze_user_factors=True)``: the same bf16 window
  read, bf16 ``eff*ff`` and dot gate; the dot is summed in another order
  (the frozen part once, then b_u's term), so within 1e-6, SSE within
  1e-3 relative (K1's); every column but b_u's bit for bit unchanged.  An f32
  ulp of the dot can flip one bf16 rounding of ``eff``, which moves that
  row's b_u by about rate * 2^-7 * |eff| (over the count with
  ``row_mean``; under 1e-3 here, the later sweeps included): a row in a
  hundred may lie that far apart (``_assert_twin``).
- the FN epoch with K1f on the user side against the same epoch with K1
  there: as the plain versions.'''
import numpy as np
import pytest
import torch

from mfrec_tpu_torch.ops import fn as fn_ops
from mfrec_tpu_torch.ops import frozen_half_pass_kernel as fk
from mfrec_tpu_torch.ops import half_pass_kernel as hk
from mfrec_tpu_torch.ops import sgd_mf
from mfrec_tpu_torch.utils import profiling

torch.set_num_threads(1)

TWIN_ATOL = 1e-6
FLIP_ATOL = 1e-3


def _assert_twin(got, want):
    diff = (got - want).abs().amax(1)
    assert float(diff.max()) <= FLIP_ATOL
    assert int((diff > TWIN_ATOL).sum()) <= max(1, diff.numel() // 100)


def _batches(kind, W, n_upd, n_fix, seed):
    '''``'random'``: five batches of random windows (masks with holes);
    ``'span'``: three batches over the same window whose row 0 holds a
    third of each, so that its ratings span every batch.'''
    rng = np.random.default_rng(seed)
    nb, B = (5, 512) if kind == 'random' else (3, 600)
    lo = np.sort(rng.integers(0, n_upd - W, nb)).astype(np.int32) \
        if kind == 'random' else np.zeros(nb, np.int32)
    kl = np.sort(rng.integers(0, W, (nb, B)), axis=1).astype(np.int32)
    if kind == 'span':
        kl[:, :B // 3] = 0
    m = (rng.random((nb, B)) > 0.1).astype(np.float32)
    r = rng.uniform(1, 5, (nb, B)).astype(np.float32)
    fix = rng.integers(0, n_fix, (nb, B)).astype(np.int32)
    return fix, r, m, kl, lo


def _factors(k, n_upd, n_fix, scale, seed):
    '''Augmented rows as FN holds them: [a | b_u | 1] and [q | 1 | b_i].'''
    rng = np.random.default_rng(seed)
    P = rng.normal(0, scale, (n_upd, k - 2)).astype(np.float32)
    Q = rng.normal(0, scale, (n_fix, k - 2)).astype(np.float32)
    bu = rng.normal(0, 0.3, n_upd).astype(np.float32)
    bi = rng.normal(0, 0.3, n_fix).astype(np.float32)
    return (torch.from_numpy(a) for a in sgd_mf.augment_factors(P, Q, bu,
                                                                bi))


def _fn_rates(k, lr_bu=0.15):
    return (torch.from_numpy(a) for a in sgd_mf.column_rates(
        k - 2, True, 0.15, 0.02, 0.02, lr_bu, 0.15, 0.01, 0.01, True,
        freeze_user_factors=True))


@pytest.mark.parametrize('kind', ['random', 'span'])
@pytest.mark.parametrize('k,opts', [
    (8, {}), (66, {}), (102, {}), (130, {}), (102, {'row_mean': False}),
    (8, {'row_mean': False}), (66, {'clamp': True}),
    (102, {'clamp_pred': False})])
def test_plain_version_matches_half_pass_ref(kind, k, opts):
    '''K1f's plain version against K1's with FN's frozen rates: rows over
    several batches (``'span'``), masked-out entries, products rounded to
    bf16 above k = 128, the sum form without ``row_mean``, and, with
    ``clamp``, factors large enough that the clamp bites on both sides.'''
    opts = dict(opts)
    clamp = opts.pop('clamp', False)
    W, n_upd, n_fix, T = 16, 120, 90, 8
    batches = tuple(torch.from_numpy(a) for a in _batches(kind, W, n_upd,
                                                          n_fix, seed=k))
    F0, Ffix = _factors(k, n_upd, n_fix, 1.0 if clamp else 0.1, seed=k)
    # the sum form steps by the count: a rate for it, as K1's tests take
    lrv, regv = _fn_rates(k, 0.01 if opts.get('row_mean') is False
                          else 0.15)
    mu = 3.4
    if clamp:
        fix, r, m, kl, lo = batches
        pred = mu + (hk._bf16(F0)[lo.long()[:, None] + kl.long()]
                     * Ffix[fix.long()]).sum(-1)
        live = m > 0
        assert bool((pred[live] > 5).any()) and bool((pred[live] < 1).any())
    Fk, Fr = F0.clone(), F0.clone()
    sse_k = fk.frozen_half_pass_ref(Fk, Ffix, batches, W, lrv, regv, mu,
                                    k - 2, T, **opts)
    sse_r = hk.half_pass_ref(Fr, Ffix, batches, W, lrv, regv, mu, T, **opts)
    _assert_twin(Fk, Fr)
    assert float(sse_k) == pytest.approx(float(sse_r), rel=1e-3)
    frozen = torch.ones(k, dtype=torch.bool)
    frozen[k - 2] = False
    assert torch.equal(Fk[:, frozen], F0[:, frozen])
    assert float((Fk[:, k - 2] - F0[:, k - 2]).abs().max()) > 0


def test_wrapper_runs_the_plain_version_on_cpu():
    '''On CPU tensors the wrapper is the plain version and launches
    nothing; it refuses a column outside the rows, bf16 fixed rows and
    K1's refusals.'''
    k, W = 66, 16
    batches = tuple(torch.from_numpy(a) for a in _batches('random', W, 120,
                                                          90, seed=3))
    F0, Ffix = _factors(k, 120, 90, 0.1, seed=3)
    lrv, regv = _fn_rates(k)
    a, b = F0.clone(), F0.clone()
    launches = fk.frozen_half_pass.launches
    sse = fk.frozen_half_pass(a, Ffix, batches, W, lrv, regv, 3.4, k - 2, 4)
    sse_p = fk.frozen_half_pass_ref(b, Ffix, batches, W, lrv, regv, 3.4,
                                    k - 2, 4)
    assert fk.frozen_half_pass.launches == launches
    assert torch.equal(a, b) and float(sse) == float(sse_p)
    with pytest.raises(ValueError, match='col'):
        fk.frozen_half_pass(a, Ffix, batches, W, lrv, regv, 3.4, k, 4)
    with pytest.raises(ValueError, match='float32'):
        fk.frozen_half_pass(a.double(), Ffix, batches, W, lrv, regv, 3.4,
                            k - 2, 4)
    with pytest.raises(ValueError, match='inner_steps'):
        fk.frozen_half_pass(a, Ffix, batches, W, lrv, regv, 3.4, k - 2, 0)
    with pytest.raises(ValueError, match='F_fix must be float32'):
        fk.frozen_half_pass(a, Ffix.bfloat16(), batches, W, lrv, regv, 3.4,
                            k - 2, 4)


@pytest.mark.parametrize('lens,warp_cap,block_cap,want', [
    ([5, 40, 3, 12], 16, 32, (1, [0], 8)),
    ([5, 40, 3, 70, 17], 16, 32, (3, [0, 38, 46], 46)),
    ([5, 3, 2], 16, 32, (0, [0], 0)),
    ([100, 100], 50, 100, (2, [0, 0], 0))])
def test_long_rows_lead_the_table(lens, warp_cap, block_cap, want):
    '''How K1f splits a table: the rows longer than a warp takes lead it
    (K1's longest-first order) and run a block each; each such row's
    region past the block's shared memory is its length less that, in
    table order.  Kept in the table's memo.'''
    rng = np.random.default_rng(1)
    W = len(lens)
    kl = np.repeat(np.arange(W), lens).astype(np.int32)[None]
    rng.shuffle(kl[0])
    kl.sort(axis=1)
    n = kl.shape[1]
    seg = hk.build_segments(rng.integers(0, 50, (1, n)).astype(np.int32),
                            rng.uniform(1, 5, (1, n)).astype(np.float32),
                            np.ones((1, n), np.float32), kl,
                            np.zeros(1, np.int32), W, 'cpu')
    n_long, off, total = fk.long_rows(seg, warp_cap, block_cap)
    assert (n_long, off.tolist(), total) == (want[0], want[1], want[2])
    assert off.dtype == torch.int32
    assert fk.long_rows(seg, warp_cap, block_cap)[1] is off


def _epoch_inputs(k=8, W=16):
    rng = np.random.default_rng(7)
    U, I, N = 60, 40, 3000
    u = rng.integers(0, U, N).astype(np.int32)
    i = rng.integers(0, I, N).astype(np.int32)
    v = rng.uniform(1, 5, N).astype(np.float32)
    keep = np.unique(u.astype(np.int64) * I + i, return_index=True)[1]
    u, i, v = u[keep], i[keep], v[keep]
    lay = {a: sgd_mf.PassLayout(sgd_mf.sorted_pass_layout(
        u, i, v, 256, a, W), a, 'cpu') for a in ('user', 'item')}
    P, Q = _factors(k, U + W, I + W, 0.1, seed=2)
    return P, Q, float(v.mean()), lay


def _count_calls(monkeypatch):
    calls = []
    real_k1, real_k1f = hk.half_pass, fk.frozen_half_pass

    def k1(F_upd, *a, **kw):
        calls.append(('k1', F_upd.data_ptr()))
        return real_k1(F_upd, *a, **kw)

    def k1f(F_upd, *a, **kw):
        calls.append(('k1f', F_upd.data_ptr()))
        return real_k1f(F_upd, *a, **kw)

    monkeypatch.setattr(hk, 'half_pass', k1)
    monkeypatch.setattr(fk, 'frozen_half_pass', k1f)
    return calls


@pytest.mark.parametrize('freeze', [True, False])
def test_epoch_routes_the_frozen_user_side_to_k1f(monkeypatch, freeze):
    '''With ``use_kernel`` on CPU tensors the epoch sends a frozen user
    half-pass to K1f's wrapper and the item half-pass to K1's; without
    ``freeze_user_factors`` K1f is never called.'''
    calls = _count_calls(monkeypatch)
    P, Q, mu, lay = _epoch_inputs()
    ep = sgd_mf.make_alternating_epoch(
        16, 16, 0.15, 0.02, lr_bu=0.1, lr_bi=0.1, K_bu=0.01, K_bi=0.01,
        bias_mode='learned', inner_steps=4, use_kernel=True,
        freeze_user_factors=freeze)
    ep(P, Q, mu, lay['user'], lay['item'])
    want = 'k1f' if freeze else 'k1'
    assert calls == [(want, P.data_ptr()), ('k1', Q.data_ptr())]


@pytest.mark.parametrize('opts', [
    {'link': 'logistic', 'bias_mode': 'learned'}, {'bias_mode': 'fixed'},
    {'bias_mode': 'none'}, {'bias_mode': 'learned', 'ff_dtype': 'bfloat16'}])
def test_epoch_refuses_a_frozen_user_side_k1f_does_not_take(opts):
    '''K1f takes FN's case alone (identity link, learned biases, f32 fixed
    rows): on the kernel path the epoch refuses a frozen user side with
    any other, and the plain path still builds it.'''
    kw = dict(lr_bu=0.1, lr_bi=0.1, freeze_user_factors=True, **opts)
    with pytest.raises(ValueError, match='freeze_user_factors'):
        sgd_mf.make_alternating_epoch(16, 16, 0.15, 0.02, use_kernel=True,
                                      **kw)
    sgd_mf.make_alternating_epoch(16, 16, 0.15, 0.02, **kw)


def test_fn_epoch_with_k1f_matches_k1(monkeypatch):
    '''The FN epoch (use_kernel, CPU tensors) with K1f on the user side
    against the same epoch with K1 there (the wrapper swapped for K1's
    plain version), as ``_assert_twin`` holds them; the user half-pass is recorded as
    ``fn.user_half_pass`` inside ``fn.half_passes``.'''
    k, W = 8, 16
    P, Q, mu, lay = _epoch_inputs(k, W)
    rng = np.random.default_rng(5)
    X = torch.from_numpy(rng.normal(0, 0.05, (Q.shape[0], k - 2)).astype(
        np.float32))
    Y = torch.from_numpy(rng.normal(0, 0.05, (Q.shape[0], k - 2)).astype(
        np.float32))
    nrm = torch.rand(P.shape[0])
    args = (W, W, 0.1, 0.05, 0.06, 0.08, 0.02, 0.01, 0.015)
    out = {}
    for route in ('k1f', 'k1'):
        if route == 'k1':
            def k1_there(F_upd, F_fix, batches, W_, lrv, regv, mu_, col,
                         T, *opts, segments=None):
                return hk.half_pass_ref(F_upd, F_fix, batches, W_, lrv, regv,
                                        mu_, T, *opts)
            monkeypatch.setattr(fk, 'frozen_half_pass', k1_there)
        ep = fn_ops.make_fn_alternating_epoch(*args, inner_steps=3,
                                              use_kernel=True)
        state = tuple(x.clone() for x in (P, Q, X, Y))
        profiling.collect()
        profiling.enable()
        try:
            *state, rmse = ep(*state, mu, lay['user'], lay['item'], nrm)
        finally:
            profiling.disable()
            spans = profiling.collect().spans
        out[route] = (state, float(rmse))
        if route == 'k1f':
            parents = {s.id: s.name for s in spans}
            inner = [parents.get(s.parent) for s in spans
                     if s.name == 'fn.user_half_pass']
            assert inner == ['fn.half_passes']
    for got, want in zip(*(out[r][0] for r in ('k1f', 'k1'))):
        _assert_twin(got, want)
    assert out['k1f'][1] == pytest.approx(out['k1'][1], rel=1e-6)

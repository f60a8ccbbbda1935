'''
Hyperparameter sweeps.

Port of ``mfrec_tpu/eval/sweep.py`` (a re-design of the reference's
``mfrec/recommendation/metaparameters.py`` sketches as working
utilities): each sweep builds and evaluates models over a parameter grid
and returns (values, scores).  ``sweep_parameter``, ``optimize_dim`` and
``optimize_similarity_threshold`` are host code, copied;
``optimize_regularization_vmapped`` trains the S models together on the
port's ``ops.sgd_mf.make_multi_reg_epoch``.  ``optimize_k`` sweeps a kNN
model's neighbourhood, and the port has no kNN model yet: it raises.
'''
from __future__ import annotations

import numpy as np
import torch

from mfrec_tpu_torch.eval.metrics import precision_recall, test_predict_rating


def sweep_parameter(factory, train_kwargs, u_test, name, values,
                    metric='rmse', predictor='predict_rating',
                    nbr_samples=5000, nbr_recommendations=5):
    '''Train a fresh model per value of parameter `name`; score on u_test.

    factory(params_dict) -> untrained model.  Returns (values, scores).
    '''
    scores = np.zeros(len(values))
    for j, val in enumerate(values):
        model = factory({name: val})
        model.train(**(train_kwargs or {}))
        if metric == 'rmse':
            scores[j] = test_predict_rating(model, u_test, nbr_samples,
                                            predictor=predictor,
                                            quiet=True)[0]
        else:
            scores[j] = precision_recall(model, u_test,
                                         nbr_recommendations)[0]
    return np.asarray(values), scores


def optimize_k(model, u_test, ks=range(5, 55, 5), nbr_samples=2000,
               predictor='predict', retrain=False):
    '''Sweep the kNN neighbourhood size (``mfrec_tpu/eval/sweep.py``):
    needs the kNN models, which are not ported yet.'''
    raise NotImplementedError(
        'optimize_k sweeps a kNN model, and the kNN models are not ported '
        'yet (ROADMAP queue 1 item 8)')


def optimize_similarity_threshold(factory, train_kwargs, u_test,
                                  thresholds=None, nbr_samples=2000,
                                  predictor='predict'):
    '''Sweep the similarity threshold (reference metaparameters.py:9-17).
    The threshold only affects prediction, so the model is trained ONCE
    and re-scored per threshold (the reference sketch retrains per point).'''
    if thresholds is None:
        thresholds = np.linspace(0.0, 0.99, 20)
    model = factory({})
    model.train(**(train_kwargs or {}))
    scores = []
    for t in thresholds:
        model.sim_threshold = float(t)
        scores.append(test_predict_rating(model, u_test, nbr_samples,
                                          predictor=predictor, quiet=True)[0])
    return np.asarray(list(thresholds)), np.asarray(scores)


def optimize_dim(factory, train_kwargs, u_test, dims=range(10, 50, 2),
                 nbr_samples=1000):
    '''reference metaparameters.py:19-29.'''
    return sweep_parameter(factory, train_kwargs, u_test, 'nbr_features',
                           list(dims), nbr_samples=nbr_samples,
                           predictor='predict')


def optimize_regularization_vmapped(users, items, values, u_test, regs,
                                    rank=16, epochs=30, lr=0.01,
                                    batch_size=8192, feature_init=0.1,
                                    seed=0, device='cuda'):
    '''Train one model per regularization value together: the factors
    stacked on a sweep axis, each batch's steps run for every model at
    once (``ops.sgd_mf.make_multi_reg_epoch``) on ``device`` ('cuda' by
    default, or 'cpu').  The same biases, batches and initial factors as
    the JAX function for the same ``seed``.  Returns (regs, test_rmses
    [S]).'''
    from mfrec_tpu_torch.models.base import resolve_device
    from mfrec_tpu_torch.ops import sgd_mf
    dev = resolve_device(device)
    users = np.asarray(users, np.int32)
    items = np.asarray(items, np.int32)
    values = np.asarray(values, np.float32)
    U, I = int(users.max()) + 1, int(items.max()) + 1
    S = len(regs)
    mu = float(values.mean())
    # fixed simple-deviation biases, shared by the sweep
    cnt_i = np.bincount(items, minlength=I)
    bi = np.where(cnt_i > 0,
                  np.bincount(items, weights=values - mu, minlength=I)
                  / np.maximum(cnt_i, 1), 0.0).astype(np.float32)
    resid = values - mu - bi[items]
    cnt_u = np.bincount(users, minlength=U)
    bu = np.where(cnt_u > 0,
                  np.bincount(users, weights=resid, minlength=U)
                  / np.maximum(cnt_u, 1), 0.0).astype(np.float32)

    # seed controls the batch shuffle and the init draw, one random init
    # shared across the sweep axis (a constant fill collapses joint
    # training to rank 1)
    ub, ib, rb, mb = sgd_mf.batch_ratings(users, items, values, batch_size,
                                          seed=int(seed))
    rng = np.random.default_rng(seed)
    P0 = rng.normal(0.0, abs(float(feature_init)),
                    (U, rank)).astype(np.float32)
    Q0 = rng.normal(0.0, abs(float(feature_init)),
                    (I, rank)).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    Ps = t(P0)[None].repeat(S, 1, 1)
    Qs = t(Q0)[None].repeat(S, 1, 1)
    Ks = t(np.asarray(regs, np.float32))
    plan = sgd_mf.fused_plan(ub, ib, dev)
    epoch = sgd_mf.make_multi_reg_epoch(lr, bias_mode='fixed')
    args = tuple(t(x) for x in (ub, ib, rb, mb))
    mu32 = float(np.float32(mu))
    for _ in range(int(epochs)):
        Ps, Qs, rmses = epoch(Ps, Qs, Ks, t(bu), t(bi), mu32, *args,
                              plan=plan)
    # vectorized held-out eval for every model at once
    test = np.asarray(u_test)
    tu = test[:, 0].astype(int)
    ti = test[:, 1].astype(int)
    tv = test[:, 2]
    Psn, Qsn = Ps.cpu().numpy(), Qs.cpu().numpy()
    pred = mu + bu[tu][None, :] + bi[ti][None, :] \
        + np.einsum('snk,snk->sn', Psn[:, tu], Qsn[:, ti])
    rmses = np.sqrt(((tv[None, :] - pred) ** 2).mean(axis=1))
    return np.asarray(regs), rmses

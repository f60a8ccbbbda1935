'''
Carry a model's state from the JAX package into the port.

Both entry points take numpy only, so neither needs jax installed:

* ``load_jax_state(path, device, model_class)`` reads the files that
  ``mfrec_tpu``'s ``BaseRecommender.save_state(path)`` writes
  (``path``_state.npz + ``path``_state.json: ratings, ``svd_u``/``svd_v``,
  biases, ``extra_*`` arrays, labels and metadata);
* ``from_numpy(...)`` builds the same model from arrays.

Each returns a port model of ``model_class`` (``GDRecommender`` by
default; a JAX checkpoint does not record its class, so the caller names
it, e.g. ``WRMFRecommender`` or ``KMFRecommender``) that computes what the JAX model computes:
P, Q, the biases and ``overall_bias``, the label indexes (so that
``add_user`` appends the same new id), and where given
``components_mean`` and FN's X and Y (a checkpoint carries X as
``extra_X`` and Y as ``items_feedback``).
'''
from __future__ import annotations

import numpy as np

from mfrec_tpu_torch.engine import checkpoint as ckpt
from mfrec_tpu_torch.models.gd import GDRecommender


def load_jax_state(path, device='cuda', model_class=GDRecommender):
    '''A ``model_class`` model on ``device`` from a JAX-package
    checkpoint.'''
    _, _, metadata = ckpt.load_state(path)
    model = model_class(int(metadata['nbr_users']),
                        int(metadata['nbr_items']), device=device)
    model.load_state(path)
    return model


def from_numpy(P, Q, users_bias, items_bias, overall_bias, ratings,
               labels=None, device='cuda', parameters=None,
               model_class=GDRecommender, components_mean=None, X=None,
               Y=None):
    '''A ``model_class`` model on ``device`` from arrays: ``P`` [users, k],
    ``Q`` [items, k], the biases (None for none), ``ratings`` as a
    ``(users, items, values)`` triple, optional ``labels``
    ``{'users': [...], 'items': [...]}``, optional ``parameters`` in
    ``PARAMETERS_INDEX`` names (a JAX model's settings, so that the port
    model trains on as the JAX model would), and optional
    ``components_mean`` [k] (the GD model's similarity centring) and
    ``X``, ``Y`` [items, k] (FN's neighbourhood factors).'''
    P = np.ascontiguousarray(P, np.float32)
    Q = np.ascontiguousarray(Q, np.float32)
    if P.ndim != 2 or Q.ndim != 2 or P.shape[1] != Q.shape[1]:
        raise ValueError('P [users, k] and Q [items, k] must share k')
    params = dict(parameters or {})
    if params.setdefault('nbr_features', P.shape[1]) != P.shape[1]:
        raise ValueError('parameters say nbr_features=%r, the factors have '
                         'k=%d' % (params['nbr_features'], P.shape[1]))
    model = model_class(P.shape[0], Q.shape[0], params, device=device)
    model.P, model.Q = P, Q
    if users_bias is not None:
        model.users_bias = np.asarray(users_bias, np.float32)
    if items_bias is not None:
        model.items_bias = np.asarray(items_bias, np.float32)
    model.overall_bias = None if overall_bias is None else float(overall_bias)
    model.set_ratings(*ratings)
    if components_mean is not None:
        model.components_mean = np.asarray(components_mean, np.float32)
    for name, arr in (('X', X), ('Y', Y)):
        if arr is not None:
            setattr(model, name, np.ascontiguousarray(arr, np.float32))
    if labels:
        model.users.labels = list(labels['users'])
        model.items.labels = list(labels['items'])
        model.build_index()
    return model

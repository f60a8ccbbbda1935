'''
Checkpoint / resume.

Mirrors the reference's persistence semantics (``base.py:557-596``: ratings
matrix + factor arrays + label maps; ``base.py:805-812``: factors-only
snapshot) without its five pickle files: one ``.npz`` for arrays and one
JSON sidecar for label maps and metadata.  Warm-start resumes
(``train(initialize_model=False)``, ``gradient_descent.py:522-525``) are a
model-layer concern and work with either format.

Copied from ``mfrec_tpu/engine/checkpoint.py``, so both packages read
and write the same files; the orbax checkpoints are not ported.
'''
from __future__ import annotations

import json
import numpy as np


def save_state(path, arrays, labels=None, metadata=None):
    '''arrays: dict[str, np.ndarray|None]; labels/metadata: JSON-able.'''
    payload = {k: np.asarray(v) for k, v in arrays.items() if v is not None}
    np.savez(str(path) + '_state.npz', **payload)
    side = {'labels': labels or {}, 'metadata': metadata or {},
            'arrays': sorted(payload.keys())}
    with open(str(path) + '_state.json', 'w') as f:
        json.dump(side, f)


def load_state(path):
    '''Returns (arrays: dict, labels: dict, metadata: dict).'''
    with np.load(str(path) + '_state.npz', allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    with open(str(path) + '_state.json') as f:
        side = json.load(f)
    return arrays, side.get('labels', {}), side.get('metadata', {})


def save_model_snapshot(path, svd_u, svd_v):
    '''Factors-only snapshot (``base.py:805-807``).'''
    np.savez(str(path) + '_model_snapshot.npz',
             svd_u=np.asarray(svd_u), svd_v=np.asarray(svd_v))


def load_model_snapshot(path):
    with np.load(str(path) + '_model_snapshot.npz') as z:
        return z['svd_u'], z['svd_v']

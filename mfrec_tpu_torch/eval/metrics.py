'''
Evaluation: rating-prediction accuracy and top-N retrieval quality.

Copied from ``mfrec_tpu/eval/metrics.py`` (host numpy; that package
imports jax): ``shannon_entropy``, ``test_predict_rating`` (RMSE / MAE /
NMAE on held-out [user, item, rating] rows through the model's
``predict_batch``), ``test_predict_rating2`` and ``precision_recall``
(P@N / R@N / F1 through ``find_recommended_items``, K3 on a CUDA model),
the same metric definitions as the reference
``mfrec/recommendation/metrics.py``.  ``tests/test_torch_foldin.py`` pins
each to the original.  ``folding_in_test`` and ``ranking_metrics`` are
not ported yet (ROADMAP queue 1 item 8).
'''
from __future__ import annotations

import numpy as np

from mfrec_tpu_torch.models.base import Error


def shannon_entropy(recommender, recommendations):
    '''Shannon entropy of the recommended-item distribution — item-space
    coverage (reference stub metrics.py:13-17, implemented).'''
    flat = np.concatenate([np.asarray(r) for r in recommendations])
    counts = np.bincount(flat.astype(int), minlength=recommender.nbr_items)
    p = counts / max(counts.sum(), 1)
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def test_predict_rating(recommender, u_test, nbr_samples=10, verbose=False,
                        predictor='predict_rating', quiet=False):
    '''RMSE/MAE/NMAE over held-out ratings (reference metrics.py:51-82).
    u_test: [n, 3] array of (user, item, rating).  Returns (rmse, errors).'''
    rows = np.asarray(u_test)[0:nbr_samples]
    users = rows[:, 0].astype(int)
    items = rows[:, 1].astype(int)
    real = rows[:, 2].astype(np.float64)

    if hasattr(recommender, 'predict_batch'):
        try:
            pred = np.asarray(
                recommender.predict_batch(items, users, predictor),
                np.float64)
        except KeyError:
            pred = None
    else:
        pred = None
    if pred is None:
        pred_list, real_list = [], []
        fn = getattr(recommender, predictor)
        for u, i, r in zip(users, items, real):
            try:
                pred_list.append(float(fn(int(i), int(u))))
                real_list.append(r)
            except Error:
                pass
        pred = np.asarray(pred_list)
        real = np.asarray(real_list)

    errors = real - pred
    errors = errors[~np.isnan(errors)]
    abs_errors = np.abs(errors)
    if abs_errors.size == 0:
        # Every prediction failed/NaN'd (e.g. a kNN predictor with
        # k < k_min finds no usable neighbors) — return NaN explicitly
        # instead of tripping numpy's empty-slice RuntimeWarning.
        if not quiet:
            print('Number of succesful rating: 0/%d' % nbr_samples)
        return float('nan'), errors
    rmse = float(np.sqrt((abs_errors ** 2).mean()))
    if not quiet:
        print('Number of succesful rating: %d/%d'
              % (len(abs_errors), nbr_samples))
        print('Mean abs. error: %s' % abs_errors.mean())
        print('Variance of the error: %s' % abs_errors.var())
        print('Mean root mean square error (RMSE): %s' % rmse)
        print('NMAE: %s' % (abs_errors.mean() / 1.6))
        print('MAE: %s' % abs_errors.mean())
    return rmse, errors


def test_predict_rating2(recommender, u_test, item_map, nbr_samples=10,
                         predictor='predict_rating', verbose=False):
    '''Variant with an item-id remap dict (reference metrics.py:19-48).'''
    rows = np.asarray(u_test)[0:nbr_samples]
    remapped = rows.copy()
    keep = []
    for j, row in enumerate(rows):
        try:
            remapped[j, 1] = item_map[int(row[1])]
            keep.append(j)
        except KeyError:
            pass
    return test_predict_rating(recommender, remapped[keep],
                               nbr_samples=len(keep), predictor=predictor,
                               verbose=verbose, quiet=not verbose)


def precision_recall(recommender, u_test, nbr_recommendations=5,
                     predictor='predict', verbose=False):
    '''P@N / R@N / F1 over per-user recommendations vs. held-out positives
    (reference metrics.py:85-130).'''
    test_sample_dict = {}
    for rating in np.asarray(u_test):
        test_sample_dict.setdefault(int(rating[0]), []).append(int(rating[1]))

    precision = recall = 0.0
    users_count = 0
    for user_index in test_sample_dict.keys():
        if user_index >= recommender.nbr_users:
            continue
        try:
            recommended = recommender.find_recommended_items(
                user_index=user_index,
                nbr_recommendations=nbr_recommendations,
                output_label=False, predictor=predictor)[0]
            recommended_set = set(recommended)
            users_count += 1
        except (KeyError, Error):
            continue
        already_rated = set(test_sample_dict[user_index])
        inter = float(len(recommended_set.intersection(already_rated)))
        precision += inter / nbr_recommendations
        recall += inter / len(already_rated)

    precision /= max(users_count, 1)
    recall /= max(users_count, 1)
    denom = precision + recall
    f_measure = 2 * precision * recall / denom if denom else 0.0
    if verbose:
        print('Precision @ %d : %s' % (nbr_recommendations, precision))
        print('Recall @ %d : %s' % (nbr_recommendations, recall))
        print('F-Measure : %s' % f_measure)
    return precision, recall, f_measure

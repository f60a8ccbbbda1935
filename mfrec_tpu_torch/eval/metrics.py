'''
Evaluation: top-N retrieval quality.  Port of ``precision_recall`` from
``mfrec_tpu/eval/metrics.py`` (same metric definitions as the reference
``mfrec/recommendation/metrics.py:85-130``); the rest of that module is
not ported yet.
'''
from __future__ import annotations

import numpy as np

from mfrec_tpu_torch.models.base import Error


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

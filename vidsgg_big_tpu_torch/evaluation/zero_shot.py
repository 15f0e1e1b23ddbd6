"""Zero-shot relation evaluation (triplets unseen in training).

A copy of the JAX package's ``evaluation/zero_shot.py`` on the port's
annotation readers and metrics (capability-parity with reference
VidVRD-helper/evaluate.py:22-53): filter GT and predictions down to the
triplets absent from the train split, then run the standard relation
metrics.
"""
from __future__ import annotations

from .metrics import evaluate


def collect_train_triplets(dataset_type: str, ann_rpath: str,
                           split: str | None = None):
    """Train-split (sub, pred, obj) name triplets from annotation JSONs.

    The reference's ``dataset.get_triplets('train')`` collection (reference
    VidVRD-helper/evaluate.py:32-33, 67-74): VidVRD reads
    ``<ann_rpath>/train/*.json``; VidOR reads
    ``<ann_rpath>/training/*/*.json``.
    """
    from ..data.annotations import VidOR, VidVRD
    if dataset_type.lower() == "vidvrd":
        split = split or "train"
        ds = VidVRD(ann_rpath, [split])
    else:
        split = split or "training"
        ds = VidOR(ann_rpath, [split])
    return {tuple(t) for t in ds.get_triplets(split)}


def evaluate_zero_shot(groundtruth, prediction, train_triplets,
                       use_old_zeroshot_eval: bool = False,
                       viou_threshold: float = 0.5, logger=None):
    """groundtruth/prediction: {vid: [relation dicts]}; train_triplets: set
    of (s, p, o) name tuples seen at training time.  Each video keeps its
    relations in their order (the filter tests membership only, so the
    sets' hash order never reaches the metrics)."""
    log = logger.info if logger is not None else (lambda *_: None)
    test_triplets = set()
    for rels in groundtruth.values():
        test_triplets.update(tuple(r["triplet"]) for r in rels)
    zs_triplets = test_triplets.difference(train_triplets)

    zs_gt, zs_pred = {}, {}
    for vid, rels in groundtruth.items():
        zs = [r for r in rels if tuple(r["triplet"]) in zs_triplets]
        if not zs:
            continue
        zs_gt[vid] = zs
        if use_old_zeroshot_eval:
            zs_pred[vid] = prediction.get(vid, [])
        else:
            zs_pred[vid] = [r for r in prediction.get(vid, [])
                            if tuple(r["triplet"]) in zs_triplets]
    log(f"-- zero-shot setting ({'old' if use_old_zeroshot_eval else 'new'})"
        f": {len(zs_triplets)} unseen triplets over {len(zs_gt)} videos")
    mean_ap, rec_at_n, mprec_at_n = evaluate(
        zs_gt, zs_pred, viou_threshold=viou_threshold)
    log(f"zero-shot detection mean AP: {mean_ap}")
    log(f"zero-shot detection recall: {rec_at_n}")
    log(f"zero-shot tagging precision: {mprec_at_n}")
    return mean_ap, rec_at_n, mprec_at_n

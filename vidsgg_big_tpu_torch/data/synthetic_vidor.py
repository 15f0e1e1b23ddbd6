"""In-memory synthetic VidOR data at the sizes the port's CLIs and
``chip_smoke.py`` run.

Records come from ``data/synthetic.make_vidor_video``: 81 entity and 51
predicate categories, RoI features followed by the 300 classeme channels
every VidOR tracklet file carries.  At the config's widths (``model_dims``)
they are full size: 2,400-frame videos (299 I3D clips, the T=512 grounding
bucket) with 12 GT + 34 distractor tracklets (46, the N=64 stage-A bucket);
otherwise they take the JAX CLIs' small synthetic widths.  Each read
draws the record anew.
"""
from __future__ import annotations

from .synthetic import clip_features, make_vidor_video

FULL_SIZE_RECIPE = dict(video_len=2400, n_gt_trajs=12, n_preds=16,
                        n_distractors=34)
# RoI width without model dims (the JAX synthetic VidOR default); VidOR
# features always carry 300 classeme channels after it
SMALL_DIM_FEAT = 64
DIM_CLASSEME = 300
# proposal features are not read by the grounding stage
GROUNDING_RECORD_FEAT_DIM = 4


def record_feat_dim(dim_feat: int, model_dims: bool) -> int:
    """The feature width of a record: RoI (the config's with
    ``model_dims``) + 300 classeme channels."""
    return (dim_feat if model_dims else SMALL_DIM_FEAT) + DIM_CLASSEME


def vidor_record(seed: int, feat_dim: int, model_dims: bool):
    """The (proposal, GT) records of synthetic video ``seed`` (named
    ``synth_{seed:06d}``)."""
    recipe = FULL_SIZE_RECIPE if model_dims else {}
    return make_vidor_video(seed, feat_dim=feat_dim, **recipe)


def synthetic_records(n_videos: int, dim_feat: int, model_dims: bool):
    """(proposal, GT) records of videos 0..n-1, generated lazily."""
    feat = record_feat_dim(dim_feat, model_dims)
    return (vidor_record(i, feat, model_dims) for i in range(n_videos))


class SyntheticVidORSet:
    """N in-memory VidOR-shaped videos for the classification trainers:
    item i is the (proposal, GT) record pair of video i at the config's
    ``dim_feat`` (with ``model_dims``) or the small width, + 300 classeme
    channels."""

    def __init__(self, n_videos: int, dim_feat: int, model_dims: bool):
        self.n, self.model_dims = n_videos, model_dims
        self.feat_dim = record_feat_dim(dim_feat, model_dims)

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        return vidor_record(i, self.feat_dim, self.model_dims)


class SyntheticGroundingSet:
    """N in-memory VidOR-shaped videos for the grounding trainer: item i is
    (clip features (num_clips, dim_feat) float32, GT record) of video i,
    made when it is read."""

    def __init__(self, n_videos: int, dim_feat: int, model_dims: bool):
        self.n, self.dim_feat = n_videos, dim_feat
        self.recipe = FULL_SIZE_RECIPE if model_dims else {}

    def __len__(self):
        return self.n

    def __getitem__(self, i: int):
        _, gt = make_vidor_video(i, feat_dim=GROUNDING_RECORD_FEAT_DIM,
                                 **self.recipe)
        return clip_features(i, gt.video_len, self.dim_feat), gt

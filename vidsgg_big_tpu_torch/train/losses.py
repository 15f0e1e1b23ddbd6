"""BIG-C training losses: vIoU target alignment, bipartite matching, CE/BCE.

Port of the JAX package's ``train/losses.py``, batched and masked:
  * proposal<->GT-trajectory alignment: reference models/model_0v10.py:559-604
  * Hungarian cost + matching:          reference models/model_0v10.py:606-639
  * classification + adjacency loss:    reference models/model_0v10.py:642-704

The losses, the vIoU and the assignment are float32 whatever the model's
compute dtype.  The alignment and the matching cost carry no gradient (the
assignment is detached, as ``stop_gradient`` in JAX).
"""
from __future__ import annotations

import torch

from ..data.types import GraphBatch, TrackletBatch
from ..ops.boxes import viou_matrix_grid
from ..ops.matching import hungarian
from ..parallel.mesh import data_sum
from ..utils.spans import span

_EPS = 1e-7


def _bce(p, target):
    p = torch.clamp(p, _EPS, 1.0 - _EPS)
    return -(target * torch.log(p) + (1.0 - target) * torch.log1p(-p))


@torch.no_grad()
def align_gt_adjacency(props: TrackletBatch, gts: GraphBatch,
                       positive_viou_th: float, t_abs: int = 1024):
    """Map GT adjacency columns from GT trajectories onto proposals.

    For every proposal, find the GT trajectories with vIoU above threshold
    (after the "every GT trajectory gets at least its best proposal"
    rescue), then copy the adjacency column of its best-vIoU GT (reference
    model_0v10.py:583-602, including the quirk that the copied column is the
    raw-vIoU argmax, not the masked one).  Ties go to the first index, as
    ``jnp.argmax``.

    Returns:
      aligned: (B, 2, P, N) float32 adjacency over proposals.
      viou: (B, N, G).
    """
    viou = viou_matrix_grid(props.boxes, props.durations, gts.traj_boxes,
                            gts.traj_durations, props.traj_mask,
                            gts.traj_mask, t_abs=t_abs)       # (B, N, G)
    mask = viou > positive_viou_th
    # rescue: each valid GT trajectory with no positive proposal claims its
    # argmax-vIoU proposal
    best_prop = torch.argmax(viou, dim=1)                     # (B, G)
    need = (mask.sum(dim=1) == 0) & gts.traj_mask             # (B, G)
    n = viou.shape[1]
    rescue = (torch.arange(n, device=viou.device)[None, :, None]
              == best_prop[:, None, :]) & need[:, None, :]    # (B, N, G)
    mask = mask | rescue

    has_any = mask.any(dim=-1) & props.traj_mask              # (B, N)
    gsel = torch.argmax(viou, dim=-1)                         # (B, N)
    adj = gts.adj.float()                                     # (B, 2, P, G)
    b, _, p, _ = adj.shape
    # aligned[:, :, :, n] = adj[:, :, :, gsel[n]] if has_any[n] else 0
    aligned = torch.gather(adj, -1, gsel[:, None, None, :].expand(
        b, 2, p, n))
    return aligned * has_any[:, None, None, :], viou


@torch.no_grad()
def matching_cost(pred_logits, att, gts: GraphBatch, aligned_adj, traj_mask,
                  cost_coeff_cls: float, cost_coeff_adj: float):
    """Per-(query, gt) assignment cost (B, Q, P), float32.

    The classification cost is the CE of each gt's category under each
    query; the adjacency cost the BCE between each query's att (B, 2, Q, N)
    and each gt's aligned adjacency (B, 2, P, N), summed over both roles
    and the valid entities and divided by 2 x their count.  The BCE sum over
    entities is written as a product, t log p + (1 - t) log(1 - p) = t
    (log p - log(1 - p)) + log(1 - p), so no (B, 2, Q, P, N) tensor is made.
    """
    b, q, _ = pred_logits.shape
    p = gts.pred_cats.shape[1]
    logp = torch.log_softmax(pred_logits.float(), dim=-1)     # (B, Q, C)
    cost_cls = -torch.gather(logp, 2, gts.pred_cats.long()[:, None, :]
                             .expand(b, q, p))                 # (B, Q, P)

    pc = torch.clamp(att.float(), _EPS, 1.0 - _EPS)           # (B, 2, Q, N)
    m = traj_mask.to(pc.dtype)[:, None, None, :]
    log_p, log_q = torch.log(pc), torch.log1p(-pc)
    t = aligned_adj.float()                                   # (B, 2, P, N)
    ll = torch.einsum("brqn,brpn->bqp", (log_p - log_q) * m, t) \
        + (log_q * m).sum(dim=(1, -1))[:, :, None]            # (B, Q, P)
    n_valid = torch.clamp(traj_mask.sum(-1), min=1).to(pc.dtype)
    cost_adj = -ll / (2.0 * n_valid[:, None, None])
    return cost_coeff_cls * cost_cls + cost_coeff_adj * cost_adj


def bigc_losses(pred_logits, att, gts: GraphBatch, aligned_adj, traj_mask,
                query4gt, num_querys: int, neg_weight: float,
                loss_coeff_cls: float, loss_coeff_adj: float, mesh=None):
    """Classification (pos/neg CE) + weighted adjacency BCE.

    Args:
      query4gt: (B, P) assigned query per gt (-1 = unmatched/padding).

    Reference semantics (model_0v10.py:642-704): CE over *all* queries with
    background target for unmatched queries, positive/negative means taken
    over the whole batch; BCE only on matched (query, gt) adjacency rows with
    ``neg_weight`` on zero targets, mean over batch x roles x entities.
    Under a ``mesh`` each count is summed over the data ranks (JAX's losses
    are global means under GSPMD): a rank's loss is its sum over the global
    count, and the ranks' losses add up to the global one.
    Returns (total, {"cls_pos", "cls_neg", "adj"}).
    """
    b, q, _ = pred_logits.shape
    matched = query4gt >= 0                                   # (B, P)
    qidx = torch.clamp(query4gt, min=0)

    # scatter gt cats onto their assigned queries; unmatched/padding gts go
    # to an overflow slot (index q) so they can never collide with a real
    # match at query 0 (matched queries are distinct by construction)
    qsafe = torch.where(matched, query4gt, torch.full_like(query4gt, q))
    upd = torch.where(matched, gts.pred_cats.long(),
                      torch.zeros_like(query4gt))
    tgt = torch.zeros(b, q + 1, dtype=torch.long,
                      device=pred_logits.device).scatter_(
        1, qsafe, upd)[:, :q]                                 # (B, Q)

    logp = torch.log_softmax(pred_logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, tgt[..., None])[..., 0]      # (B, Q)
    # fully-masked batch slots (remainder-padding repeats from the bucketer)
    # contribute no queries to either CE mean
    video_valid = traj_mask.any(-1)                           # (B,)
    pos = tgt != 0
    neg = (~pos) & video_valid[:, None]
    n_pos = torch.clamp(data_sum(pos.sum(), mesh), min=1)
    n_neg = torch.clamp(data_sum(neg.sum(), mesh), min=1)
    cls_pos = (ce * pos).sum() / n_pos
    cls_neg = (ce * neg).sum() / n_neg

    # adjacency BCE on matched pairs: att at each gt's query (an index: on
    # the card its backward sums duplicates in a fixed order)
    att_m = att.float()[torch.arange(b, device=att.device)[:, None, None],
                        torch.arange(2, device=att.device)[None, :, None],
                        qidx[:, None, :]]                     # (B, 2, P, N)
    bce = _bce(att_m, aligned_adj)
    w = torch.where(aligned_adj > 0.5, torch.ones_like(bce),
                    torch.full_like(bce, neg_weight))
    sel = (matched[:, None, :, None] & traj_mask[:, None, None, :]).to(
        bce.dtype)
    # reference means over every (role, matched gt, valid entity) element
    elem = torch.clamp(data_sum(sel.expand_as(bce).sum(), mesh), min=1.0)
    adj_loss = (bce * w * sel).sum() / elem

    loss_dict = {
        "cls_pos": loss_coeff_cls * cls_pos,
        "cls_neg": loss_coeff_cls * cls_neg,
        "adj": loss_coeff_adj * adj_loss,
    }
    total = sum(loss_dict.values())
    return total, loss_dict


def bigc_train_loss(outputs, props: TrackletBatch, gts: GraphBatch, cfg,
                    t_abs: int = 1024, mesh=None):
    """Full training loss from model outputs (cfg: BigCConfig):
    (total, {"cls_pos", "cls_neg", "adj"}, (query4gt, cost)).

    ``t_abs`` must cover the video-length bound of the dataset (vIoU grid
    anchoring, ops/boxes.viou_matrix_grid): tools/train_vidvrd passes 4096.
    The matching cost goes to the host once (ops/matching.hungarian).  The
    third element, which JAX's counterpart does not return, is the
    matching: the (B, P) assignment and the (B, Q, P) cost it solved, both
    without gradient.  ``mesh``: the counts are global (:func:`bigc_losses`).
    """
    with span("loss"):
        with span("align"):
            aligned, _ = align_gt_adjacency(props, gts, cfg.positive_viou_th,
                                            t_abs=t_abs)
        with span("match"):
            cost = matching_cost(
                outputs["pred_logits"], outputs["att"], gts, aligned,
                props.traj_mask, cfg.cost_coeff_cls, cfg.cost_coeff_adj)
            query4gt = hungarian(cost, gts.pred_mask.sum(-1))
        with span("terms"):
            total, terms = bigc_losses(
                outputs["pred_logits"], outputs["att"], gts, aligned,
                props.traj_mask, query4gt, cfg.num_querys, cfg.neg_weight,
                cfg.loss_coeff_cls, cfg.loss_coeff_adj, mesh=mesh)
    return total, terms, (query4gt, cost)

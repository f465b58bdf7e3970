"""The GenerativeODE's composite masked loss (port of
``ananke_abm_tpu/models/latent_ode/loss.py``): masked location CE, the
time-weighted interpolated embedding MSE, the physical distance of the
argmax prediction (distance_matrix[argmax, gt]), purpose / mode CE and
feature MSE, and the KL of h0."""
from __future__ import annotations

import torch

# the components, in the reference's order
COMPONENTS = ("total", "classification", "embedding", "distance",
              "purpose_class", "purpose_mse", "mode_class", "mode_mse", "kl")


def _masked_ce(logits, labels, mask):
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
    nll = torch.where(labels < 0, torch.zeros_like(nll), nll)  # ignore -1
    return torch.sum(nll * mask) / torch.sum(mask).clamp_min(1.0)


def calculate_composite_loss(batch, outputs, candidate_embeds, config):
    """``(total, components)`` over the unified-timeline batch (tensors,
    the keys of ``train.BATCH_ARRAY_KEYS``)."""
    (loc_logits, loc_embed, purp_logits, mode_logits, purpose_feat,
     mode_feat, mu, logvar) = outputs
    t = batch["t_unified"]
    y_loc = batch["y_loc_dense"]
    mask = batch["loss_mask"]
    msum = torch.sum(mask).clamp_min(1.0)
    B = loc_logits.shape[0]

    l_class = _masked_ce(loc_logits, y_loc, mask)

    prev_i = batch["prev_real_indices"]
    next_i = batch["next_real_indices"]
    prev_emb = candidate_embeds[torch.gather(y_loc, 1, prev_i).clamp_min(0)]
    next_emb = candidate_embeds[torch.gather(y_loc, 1, next_i).clamp_min(0)]
    t_prev, t_next = t[prev_i], t[next_i]
    w_next = torch.clamp((t[None, :] - t_prev) / (t_next - t_prev + 1e-8),
                         0.0, 1.0)[..., None]
    target_emb = (1 - w_next) * prev_emb + w_next * next_emb
    l_embed = torch.sum(torch.mean((loc_embed - target_emb) ** 2, -1)
                        * mask) / msum

    # the argmax takes the first index on ties, as jnp.argmax
    pred_ids = torch.argmax(loc_logits, dim=-1)
    phys = batch["distance_matrix"][pred_ids, y_loc.clamp_min(0)]
    l_dist = torch.sum(phys * mask) / msum

    l_purp = _masked_ce(purp_logits, batch["y_purp_dense"], mask)
    l_purp_mse = torch.sum(torch.mean(
        (purpose_feat - batch["y_purp_feat_dense"]) ** 2, -1) * mask) / msum
    l_mode = _masked_ce(mode_logits, batch["y_mode_dense"], mask)
    l_mode_mse = torch.sum(torch.mean(
        (mode_feat - batch["y_mode_feat_dense"]) ** 2, -1) * mask) / msum

    kl = -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar)) / B

    total = (config.loss_weight_classification * l_class
             + config.loss_weight_embedding * l_embed
             + config.loss_weight_distance * l_dist
             + config.loss_weight_purpose_class * l_purp
             + config.loss_weight_mode_class * l_mode
             + config.loss_weight_purpose_mse * l_purp_mse
             + config.loss_weight_mode_mse * l_mode_mse
             + config.kl_weight * kl)
    comps = dict(zip(COMPONENTS, (total, l_class, l_embed, l_dist, l_purp,
                                  l_purp_mse, l_mode, l_mode_mse, kl)))
    return total, comps

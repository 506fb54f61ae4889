"""Event clustering: connected components of the motion-compensated count
image, with each cluster's mean flow, in PyTorch.

Counterpart of ``better_flow_tpu/models/clustering.py``.  The reference
ships only a stub of its segmentation stage (clustering.h/.cpp: a Cluster
with an id counter and a merge by id; Event's cl/cl_id, event.h:23-24);
the JAX package adds a working baseline, kept here: 4-connected components
by label propagation (rounds of the 4-neighbour maximum of seed labels),
on the device; the per-event bookkeeping stays on the host in numpy, as
there.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from better_flow_tpu_torch.runtime.scan_pipeline import default_device


class ClusterAssignment(NamedTuple):
    cluster_id: np.ndarray   # i32[N] per-event cluster id, -1 = unclustered
    n_clusters: int          # number of distinct clusters
    label_img: np.ndarray    # i32[H, W] pixel labels (0 = background)


def label_components(occ: torch.Tensor, n_iters: int = 64) -> torch.Tensor:
    """4-connected components of a boolean (H, W) image by label
    propagation: each occupied pixel starts with its linear index + 1, and
    ``n_iters`` rounds of the 4-neighbour maximum merge touching pixels
    (``n_iters`` bounds the component's diameter).  Returns int32 labels,
    0 off the components, on ``occ``'s device."""
    H, W = occ.shape
    lab = ((torch.arange(H * W, dtype=torch.int32, device=occ.device)
            .reshape(H, W) + 1) * occ)
    zero = torch.zeros_like(lab)
    for _ in range(n_iters):
        p = torch.nn.functional.pad(lab, (1, 1, 1, 1))
        nb = torch.maximum(torch.maximum(p[:-2, 1:-1], p[2:, 1:-1]),
                           torch.maximum(p[1:-1, :-2], p[1:-1, 2:]))
        lab = torch.where(occ, torch.maximum(lab, nb), zero)
    return lab


def cluster_events(pr_x, pr_y, u, v, mask, scale: int, res_x: int,
                   res_y: int, min_count: int = 2, n_iters: int = 64,
                   device=None) -> dict:
    """Segment events by connected support in the compensated image:
    per-event cluster ids (0..K-1 in label order, -1 outside any
    component), the cluster count, each cluster's size and mean flow, and
    the label image (the data of the reference's color_clusters_img,
    event_file.h:560-646).  ``device``: where the components are labelled,
    the card unless ``"cpu"`` is passed."""
    dev = torch.device(device) if device is not None else default_device()
    pr_x = np.asarray(pr_x, np.float64)
    pr_y = np.asarray(pr_y, np.float64)
    H, W = res_x * scale + scale, res_y * scale + scale
    ix = np.trunc(pr_x * scale).astype(np.int64) + scale // 2
    iy = np.trunc(pr_y * scale).astype(np.int64) + scale // 2
    ok = (np.asarray(mask, bool) & (ix >= 0) & (ix < H) & (iy >= 0)
          & (iy < W))
    cnt = np.zeros((H, W), np.int32)
    np.add.at(cnt, (ix[ok], iy[ok]), 1)
    occ = (cnt > 0) & (cnt >= min_count)
    labels = label_components(torch.from_numpy(occ).to(dev),
                              n_iters=n_iters).cpu().numpy()

    ev_label = np.zeros(len(pr_x), np.int64)
    ev_label[ok] = labels[ix[ok], iy[ok]]
    uniq = np.unique(ev_label[ev_label > 0])
    cluster_id = np.where(ev_label > 0, np.searchsorted(uniq, ev_label),
                          -1).astype(np.int32)
    k = len(uniq)
    mean_u = np.zeros(k)
    mean_v = np.zeros(k)
    sizes = np.zeros(k, np.int64)
    u = np.asarray(u)
    v = np.asarray(v)
    for i in range(k):
        sel = cluster_id == i
        sizes[i] = sel.sum()
        if sizes[i]:
            mean_u[i] = u[sel].mean()
            mean_v[i] = v[sel].mean()
    return {"cluster_id": cluster_id, "n_clusters": k, "sizes": sizes,
            "mean_u": mean_u, "mean_v": mean_v, "label_img": labels}


def merge_clusters(cluster_id: np.ndarray, a: int, b: int) -> np.ndarray:
    """Cluster::operator+= (clustering.cpp:22-25): absorb b into a."""
    out = np.asarray(cluster_id).copy()
    out[out == b] = a
    return out

"""Deep-embedded clustering over clause embeddings; port of
carel_tpu/tools/clustering.py.

The reference's ECPE_discovery.py / run_DCC_pairwise.py depend on a `lib/`
package (IDEC / DCC) that is absent from its repository. This module is the
JAX package's working equivalent:

- a [500, 500, 2000] -> z autoencoder (the IDEC geometry, ECPE_discovery.py
  :10-30), Flax-style init, pretrained with MSE;
- DEC/IDEC refinement: Student-t soft assignments against K-means-initialised
  centres, the sharpened-target KL objective plus the reconstruction term,
  and optional must-link / cannot-link penalties (the DCC variant), one Adam
  over the params and the centres;
- the chi-squared contingency test between cluster and emotion label that
  ECPE_discovery runs on the result (scipy, imported when it is called).

K-means runs in numpy on the host, a copy of JAX's. Layer names match
Flax's (``enc_0`` ... ``out``), so convert.py maps its params.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from carel_tpu_torch.device import resolve_device
from carel_tpu_torch.models.encoder import init_flax_
from carel_tpu_torch.train.state import adam


class AutoEncoder(nn.Module):
    def __init__(self, in_dim: int, z_dim: int = 10,
                 hidden: Tuple[int, ...] = (500, 500, 2000)):
        super().__init__()
        dims = (in_dim, *hidden)
        for i in range(len(hidden)):
            self.add_module(f"enc_{i}", nn.Linear(dims[i], dims[i + 1]))
        self.z = nn.Linear(hidden[-1], z_dim)
        back = (z_dim, *reversed(hidden))
        for i in range(len(hidden)):
            self.add_module(f"dec_{i}", nn.Linear(back[i], back[i + 1]))
        self.out = nn.Linear(hidden[0], in_dim)
        self.depth = len(hidden)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = x
        for i in range(self.depth):
            h = F.relu(getattr(self, f"enc_{i}")(h))
        z = self.z(h)
        h = z
        for i in range(self.depth):
            h = F.relu(getattr(self, f"dec_{i}")(h))
        return z, self.out(h)


def _kmeans(z: np.ndarray, k: int, seed: int = 42, iters: int = 50
            ) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = z[rng.choice(len(z), size=min(k, len(z)), replace=False)]
    for _ in range(iters):
        d2 = ((z[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        assign = d2.argmin(1)
        new = np.stack([
            z[assign == j].mean(0) if (assign == j).any() else centers[j]
            for j in range(len(centers))])
        if np.allclose(new, centers):
            break
        centers = new
    return centers


def _student_t(z: torch.Tensor, centers: torch.Tensor,
               alpha: float = 1.0) -> torch.Tensor:
    d2 = torch.sum((z[:, None, :] - centers[None, :, :]) ** 2, -1)
    q = (1.0 + d2 / alpha) ** (-(alpha + 1.0) / 2.0)
    return q / torch.sum(q, dim=1, keepdim=True)


def _target_dist(q: torch.Tensor) -> torch.Tensor:
    w = q ** 2 / torch.sum(q, dim=0, keepdim=True)
    return w / torch.sum(w, dim=1, keepdim=True)


@dataclass
class IdecConfig:
    z_dim: int = 10
    n_clusters: int = 25  # ECPE_discovery.py:21
    pretrain_epochs: int = 50
    refine_steps: int = 100
    batch_size: int = 256
    lr: float = 1e-3
    gamma: float = 0.1  # weight of the clustering KL vs reconstruction
    constraint_weight: float = 1.0
    seed: int = 42


def train_idec(
    data: np.ndarray,
    cfg: IdecConfig = IdecConfig(),
    must_link: Optional[np.ndarray] = None,  # [M, 2] index pairs
    cannot_link: Optional[np.ndarray] = None,
    logger=None,
    device="cuda",
    params: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[np.ndarray, dict]:
    """Cluster assignments + artifacts for clause embeddings [N, D], on
    ``device`` (the GPU unless "cpu" is asked for). ``params`` (the
    autoencoder's state_dict) replaces the random init from ``cfg.seed``.
    Pretraining takes every batch of a shuffle (the last one shorter), as
    JAX's loop does; refinement takes the whole set each step, its target
    from the current assignments."""
    device = resolve_device(device)
    data = np.asarray(data, np.float32)
    n = len(data)
    model = AutoEncoder(data.shape[1], cfg.z_dim)
    if params is None:
        init_flax_(model, torch.Generator().manual_seed(cfg.seed))
    else:
        model.load_state_dict(params)
    model.to(device)
    x_all = torch.from_numpy(data).to(device)
    opt = adam(list(model.parameters()), cfg.lr, device)

    drng = np.random.default_rng(cfg.seed)
    for epoch in range(cfg.pretrain_epochs):
        order = torch.from_numpy(drng.permutation(n)).to(device)
        for s in range(0, n, cfg.batch_size):
            x = x_all[order[s: s + cfg.batch_size]]
            opt.zero_grad(set_to_none=True)
            loss = torch.mean((model(x)[1] - x) ** 2)
            loss.backward()
            opt.step()
        if logger and epoch % 10 == 9:
            logger.log({"event": "idec_pretrain", "epoch": epoch + 1,
                        "mse": float(loss)})

    with torch.no_grad():
        z0 = model(x_all)[0].cpu().numpy()
    centers = nn.Parameter(torch.from_numpy(
        _kmeans(z0, cfg.n_clusters, cfg.seed)).to(device))
    opt2 = adam([*model.parameters(), centers], cfg.lr, device)
    ml = (torch.as_tensor(must_link, dtype=torch.long, device=device)
          if must_link is not None else None)
    cl = (torch.as_tensor(cannot_link, dtype=torch.long, device=device)
          if cannot_link is not None else None)

    for step in range(cfg.refine_steps):
        with torch.no_grad():
            target = _target_dist(_student_t(model(x_all)[0], centers))
        opt2.zero_grad(set_to_none=True)
        z, x_hat = model(x_all)
        q = _student_t(z, centers)
        kl = torch.sum(target * torch.log(
            torch.clamp_min(target, 1e-12) / torch.clamp_min(q, 1e-12))) / n
        loss = torch.mean((x_hat - x_all) ** 2) + cfg.gamma * kl
        if ml is not None and len(ml):
            loss = loss + cfg.constraint_weight * torch.mean(
                torch.sum((q[ml[:, 0]] - q[ml[:, 1]]) ** 2, -1))
        if cl is not None and len(cl):
            loss = loss - cfg.constraint_weight * torch.mean(
                torch.sum((q[cl[:, 0]] - q[cl[:, 1]]) ** 2, -1))
        loss.backward()
        opt2.step()
        if logger and step % 20 == 19:
            logger.log({"event": "idec_refine", "step": step + 1,
                        "loss": float(loss)})

    with torch.no_grad():
        q = _student_t(model(x_all)[0], centers).cpu().numpy()
    return q.argmax(1), {"q": q, "params": model.state_dict(),
                         "centers": centers.detach().cpu().numpy()}


def emotion_cluster_chi2(assignments: Sequence[int],
                         emotions: Sequence[int]) -> dict:
    """Chi-squared contingency test between cluster ids and emotion labels
    (ECPE_discovery.py:24-30)."""
    from scipy.stats import chi2_contingency

    assignments = np.asarray(assignments)
    emotions = np.asarray(emotions)
    clusters = np.unique(assignments)
    emos = np.unique(emotions)
    table = np.zeros((len(clusters), len(emos)), np.int64)
    for i, c in enumerate(clusters):
        for j, e in enumerate(emos):
            table[i, j] = int(((assignments == c) & (emotions == e)).sum())
    # drop all-zero rows/cols to keep the test well-defined
    table = table[table.sum(1) > 0][:, table.sum(0) > 0]
    chi2, p, dof, _ = chi2_contingency(table)
    return {"chi2": float(chi2), "p_value": float(p), "dof": int(dof),
            "table": table}

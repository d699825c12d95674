"""Genotype extraction (numpy, on the host) and the entropy regulariser
(torch, differentiable).

Port of ``npp_tpu/models/genotype_parse.py``: ``btw_np`` is the per-step
softmax over the growing beta groups, ``parse_topp`` the greedy
top-probability edge selection of the inter-task connections (until the
picked weights sum to 0.7 or 4 edges), ``parse_popa`` the top-2 edges per
step of the fusion cells, ``extract_genotype`` assembles the
(GenotypeInter, GenotypeFuse) pair, and ``loss_entropy`` is the mean
normalised categorical entropy of the alpha softmaxes that the arch step
adds to its loss.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from npp_tpu_torch import genotypes as gt


def np_softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    e = np.exp(x - np.max(x, axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def btw_np(betas: np.ndarray, n_input: int, steps: int) -> np.ndarray:
    out = []
    start, n = 0, n_input
    for _ in range(steps):
        out.append(np_softmax(betas[start:start + n]))
        start += n
        n += 1
    return np.concatenate(out, axis=0)


def parse_topp(alpha_w: np.ndarray, beta_w: np.ndarray, n_input: int,
               steps: int, primitives=gt.PRIMITIVES_INTER,
               prob_threshold: float = 0.7, max_edges: int = 4):
    """Per step, greedily take the largest (edge, op) weights until their
    sum reaches the threshold or ``max_edges`` edges."""
    gene, weight_lists = [], []
    start, n = 0, n_input
    for _ in range(steps):
        w = alpha_w[start:start + n].copy()
        w = w * beta_w[start:start + n, None]
        prob = 0.0
        edges, picked = [], []
        while prob < prob_threshold and len(edges) < max_edges:
            m = np.max(w)
            prob += m
            j, k = np.unravel_index(np.argmax(w), w.shape)
            w[j, k] = 0
            picked.append(m)
            edges.append((primitives[k], int(j)))
        gene.append(edges)
        weight_lists.append(np.asarray(picked) / np.sum(picked))
        start += n
        n += 1
    return gene, weight_lists


def parse_popa(alpha_w: np.ndarray, beta_w: np.ndarray, steps: int = 4,
               n_input: int = 3, primitives=gt.PRIMITIVES_INTER):
    """Top-2 edges per step (ranked by each edge's best op weight), the
    best op of each chosen edge."""
    gene = []
    start, n = 0, n_input
    for _ in range(steps):
        w = alpha_w[start:start + n].copy()
        w = w * beta_w[start:start + n, None]
        edges = sorted(range(n), key=lambda x: -np.max(w[x]))[:2]
        for j in edges:
            k_best = int(np.argmax(w[j]))
            gene.append((primitives[k_best], int(j)))
        start += n
        n += 1
    return gene


def extract_genotype(arch_params: dict):
    """(GenotypeInter, GenotypeFuse) from the supernet's architecture
    parameters, given as numpy arrays (or tensors) by name."""
    a = {k: np.asarray(v, np.float64) for k, v in arch_params.items()}

    g1, _ = parse_topp(np_softmax(a["alphas1"]), btw_np(a["betas1"], 1, 4),
                       n_input=1, steps=4)
    g2, _ = parse_topp(np_softmax(a["alphas2"]), btw_np(a["betas2"], 1, 4),
                       n_input=1, steps=4)
    g3, _ = parse_topp(np_softmax(a["alphas3"]), btw_np(a["betas3"], 5, 3),
                       n_input=5, steps=3)
    g4, _ = parse_topp(np_softmax(a["alphas4"]), btw_np(a["betas4"], 5, 3),
                       n_input=5, steps=3)
    genotype_inter = gt.GenotypeInter(
        task1=tuple(tuple(g) for g in g1),
        task2=tuple(tuple(g) for g in g2),
        task3=tuple(tuple(g) for g in g3),
        task4=tuple(tuple(g) for g in g4),
    )

    gp = parse_popa(np_softmax(a["alphas_pose"]),
                    btw_np(a["betas_pose"], 3, 4))
    gr = parse_popa(np_softmax(a["alphas_par"]), btw_np(a["betas_par"], 3, 4))
    genotype_fuse = gt.GenotypeFuse(
        pose=tuple(gp), pose_concat=tuple(range(3, 7)),
        par=tuple(gr), par_concat=tuple(range(3, 7)),
    )
    return genotype_inter, genotype_fuse


def loss_entropy(arch_params: dict) -> torch.Tensor:
    """0.25 * 2 / 12 x the sum over the six alpha matrices of the mean
    normalised entropy of their row softmaxes (12: the six alphas and six
    betas of the reference's parameter list)."""
    en = 0.0
    for k in ("alphas1", "alphas2", "alphas3", "alphas4", "alphas_pose",
              "alphas_par"):
        al = arch_params[k]
        p = torch.softmax(al, dim=-1)
        ent = -torch.sum(p * torch.log(torch.clamp(p, min=1e-12)), dim=-1)
        en = en + torch.mean(ent / math.log(al.shape[1]))
    return 0.25 * 2 * en / 12

"""Genotype schema, the search's candidate sets, the released NPPNet
architecture genotypes and their JSON form.

A jax-free copy of ``npp_tpu/genotypes.py:17-215``, so that nothing on
the port's path imports the JAX package. ``tests/test_torch_model.py``
holds the two copies equal, and ``tests/test_torch_search.py`` the JSON
byte for byte.

An edge is ``(op_name, input_index)``; ``input_index`` addresses the
cell's running state list (DARTS convention).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Sequence

Edge = tuple[str, int]


def _edges(pairs: Sequence[Sequence]) -> tuple[Edge, ...]:
    return tuple((str(n), int(i)) for n, i in pairs)


def _groups(groups: Sequence[Sequence[Sequence]]) -> tuple[tuple[Edge, ...], ...]:
    return tuple(_edges(g) for g in groups)


@dataclass(frozen=True)
class Genotype:
    """Encoder cell genotype."""

    normal: tuple[Edge, ...]
    normal_concat: tuple[int, ...]
    reduce: tuple[Edge, ...]
    reduce_concat: tuple[int, ...]


@dataclass(frozen=True)
class GenotypeUp2:
    """Decoder genotype for the two branches."""

    upsample1: tuple[Edge, ...]
    upsample_concat1: tuple[int, ...]
    upsample2: tuple[Edge, ...]
    upsample_concat2: tuple[int, ...]


@dataclass(frozen=True)
class GenotypeInter:
    """Inter-task connections: ``task1``/``task2`` are the encoder-stage
    injections into the pose / parsing stream (one group per scale),
    ``task3``/``task4`` the decoder-stage ones (one group per stage,
    indices into the 7-slot feature pyramid)."""

    task1: tuple[tuple[Edge, ...], ...]
    task2: tuple[tuple[Edge, ...], ...]
    task3: tuple[tuple[Edge, ...], ...]
    task4: tuple[tuple[Edge, ...], ...]


@dataclass(frozen=True)
class GenotypeFuse:
    """Refinement (fusion) cell genotype."""

    pose: tuple[Edge, ...]
    pose_concat: tuple[int, ...]
    par: tuple[Edge, ...]
    par_concat: tuple[int, ...]


# Candidate primitive sets of the search.
PRIMITIVES_PC = (
    "std_conv_3x3",
    "se_connect",
    "dil_conv_3x3_4",
    "dil_conv_3x3_2",
    "std_conv_1x1",
    "max_pool_3x3",
    "skip_connect",
)

PRIMITIVES_INTER = (
    "std_conv_3x3",
    "dil_conv_3x3_4",
    "se_connect",
    "max_pool_3x3",
    "dil_conv_3x3_2",
    "std_conv_1x1",
    "poled_conv_x1",
)

ENCODER = Genotype(
    normal=_edges([
        ("std_conv_3x3", 0), ("se_connect", 1),
        ("se_connect", 1), ("std_conv_3x3", 0),
        ("max_pool_3x3", 1), ("std_conv_3x3", 2),
        ("std_conv_3x3", 3), ("std_conv_3x3", 0),
    ]),
    normal_concat=tuple(range(2, 6)),
    reduce=_edges([
        ("std_conv_3x3", 0), ("se_connect", 1),
        ("se_connect", 1), ("std_conv_3x3", 2),
        ("dil_conv_3x3_4", 3), ("dil_conv_3x3_4", 2),
        ("max_pool_3x3", 3), ("dil_conv_3x3_2", 0),
    ]),
    reduce_concat=tuple(range(2, 6)),
)

DECODER = GenotypeUp2(
    upsample1=_edges([
        ("std_conv_1x1", 1), ("std_conv_1x1", 0),
        ("std_conv_1x1", 1), ("std_conv_3x3", 0),
        ("std_conv_1x1", 0), ("dil_conv_3x3_2", 1),
        ("std_conv_3x3", 3), ("std_conv_1x1", 1),
    ]),
    upsample_concat1=tuple(range(2, 6)),
    upsample2=_edges([
        ("std_conv_3x3", 1), ("se_connect", 0),
        ("dil_conv_3x3_2", 2), ("std_conv_1x1", 1),
        ("poled_conv_x1", 3), ("std_conv_1x1", 2),
        ("std_conv_3x3", 1), ("std_conv_1x1", 2),
    ]),
    upsample_concat2=tuple(range(2, 6)),
)

INTER = GenotypeInter(
    task1=_groups([
        [("dil_conv_3x3_2", 0)],
        [("std_conv_3x3", 1)],
        [("std_conv_1x1", 1), ("std_conv_3x3", 2)],
        [("std_conv_1x1", 2), ("std_conv_3x3", 3)],
    ]),
    task2=_groups([
        [("dil_conv_3x3_2", 0)],
        [("poled_conv_x1", 1)],
        [("std_conv_1x1", 2)],
        [("std_conv_3x3", 1), ("std_conv_3x3", 3)],
    ]),
    task3=_groups([
        [("dil_conv_3x3_2", 4), ("dil_conv_3x3_2", 2), ("dil_conv_3x3_2", 1)],
        [("std_conv_3x3", 1), ("std_conv_3x3", 2), ("dil_conv_3x3_2", 5),
         ("dil_conv_3x3_2", 0)],
        [("std_conv_3x3", 1), ("dil_conv_3x3_2", 2), ("dil_conv_3x3_4", 5),
         ("dil_conv_3x3_2", 3)],
    ]),
    task4=_groups([
        [("std_conv_3x3", 0)],
        [("std_conv_3x3", 1)],
        [("std_conv_1x1", 2), ("std_conv_3x3", 1)],
    ]),
)

FUSION = GenotypeFuse(
    pose=_edges([
        ("std_conv_3x3", 1), ("std_conv_3x3", 2),
        ("std_conv_3x3", 0), ("max_pool_3x3", 2),
        ("std_conv_3x3", 4), ("std_conv_3x3", 2),
        ("std_conv_3x3", 4), ("std_conv_3x3", 3),
    ]),
    pose_concat=tuple(range(3, 7)),
    par=_edges([
        ("dil_conv_3x3_2", 2), ("se_connect", 1),
        ("dil_conv_3x3_2", 2), ("dil_conv_3x3_2", 3),
        ("max_pool_3x3", 3), ("std_conv_3x3", 2),
        ("dil_conv_3x3_2", 5), ("std_conv_3x3", 2),
    ]),
    par_concat=tuple(range(3, 7)),
)


def save_genotypes(path: str, inter: GenotypeInter, fuse: GenotypeFuse,
                   meta: dict | None = None) -> None:
    """Write a searched (inter, fuse) pair as JSON, the form the augment
    phase reads back with ``load_genotypes``."""
    payload = {
        "inter": {k: [[list(e) for e in g] for g in getattr(inter, k)]
                  for k in ("task1", "task2", "task3", "task4")},
        "fuse": {
            "pose": [list(e) for e in fuse.pose],
            "pose_concat": list(fuse.pose_concat),
            "par": [list(e) for e in fuse.par],
            "par_concat": list(fuse.par_concat),
        },
        "meta": meta or {},
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def load_genotypes(path: str) -> tuple[GenotypeInter, GenotypeFuse]:
    with open(path) as f:
        payload = json.load(f)
    inter = GenotypeInter(**{k: _groups(v)
                             for k, v in payload["inter"].items()})
    f_ = payload["fuse"]
    fuse = GenotypeFuse(pose=_edges(f_["pose"]),
                        pose_concat=tuple(f_["pose_concat"]),
                        par=_edges(f_["par"]),
                        par_concat=tuple(f_["par_concat"]))
    return inter, fuse

"""Genotype schema and the released NPPNet architecture genotypes.

A jax-free copy of ``npp_tpu/genotypes.py:17-176`` (the schema and the
released genotypes only), so that nothing on the port's path imports the
JAX package. ``tests/test_torch_model.py`` holds the two copies equal.

An edge is ``(op_name, input_index)``; ``input_index`` addresses the
cell's running state list (DARTS convention).
"""
from __future__ import annotations

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

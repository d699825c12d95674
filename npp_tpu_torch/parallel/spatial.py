"""Spatial partitioning (sp): the image height split over the ranks of a
grid's ``space`` axis.

Port of ``npp_tpu/parallel/spatial.py``. In npp_tpu the image H axis is
sharded over a mesh axis and XLA's SPMD partitioner puts the halo
exchanges into every conv, pool and resize. PyTorch has no partitioner,
so the port does that work itself. On a ``data x space`` grid
(``mesh.make_grid``) rank (d, s) holds data shard d and rows
[s * H / n, (s + 1) * H / n) of its images (n = ``n_space``), and
``convert_spatial(model, grid)`` makes NPPNet's ops run on those rows:

- a conv or pool whose window reaches across rows takes its
  neighbours' boundary rows (``halo_rows``; the backward sends each halo
  row's gradient back to its owner and adds it there), runs on
  [halo above, own rows, halo below] with its own padding, which then
  falls only on the image's top and bottom, and keeps its own output
  rows. So zero padding, max pool's -inf padding and the 3x3 average
  pool's divisor (``count_include_pad=False``: halo rows count, the
  image's padding does not) are the unsharded op's;
- the squeeze-excitation mean is a sum over the space group
  (``sum_over_space``) divided by H * W;
- a bilinear resize gathers all rows first (``gather_rows``, whose
  backward sums the gradient over the group and keeps the owner's rows),
  resizes and keeps its own output rows: the source rows of an output
  row lie anywhere in the image. It computes every output row on every
  rank of the group;
- a level whose height n does not divide (NPPNet's 1/32 level at 64 px
  and n = 4) is held whole on every rank of the group ("replicated"),
  and so is the output of a stride-2 op whose shards do not start on even
  rows: the op gathers the rows, computes the whole level, and keeps its
  own rows again where the output height divides. The cross-rank BN
  counts a replicated level's values once (``sync_bn.py``). npp_tpu's
  XLA pads uneven shards instead; the numbers are the same.

Whether a level is sharded depends on its global height alone
(``is_sharded``), but a rank sees only its local height, and a sharded
8-row level at n = 4 looks like a replicated 2-row one. So a converted
model learns each op's global input height once per input height: the
first forward at a new height runs the model unsharded in eval mode on a
zero image of one sample at the full height, under ``torch.no_grad``,
and records the heights of its ops in call order (the plan); a sharded
forward then reads them back in the same order and checks each against
the local height.

npp_tpu's serving layouts run here too: the fused sibling cells (their
group modules read rows as the ops they merge do) and int8 dense convs
(``ShardedInt8Conv2d``: the int8 conv on the row window, its dynamic
scale the grid's, ``ops/quantize.grid_quantize``).

Every exchange is an all-reduce over the space group of a zeroed buffer
with a slot per rank (``mesh.all_slots``): gloo has no all-gather of
CUDA tensors, and adding zeros is exact. bf16 and fp16 travel as
float32. One code path serves gloo and NCCL.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist
import torch.nn as nn

from npp_tpu_torch.ops.quantize import INT8_CONVS, Int8Conv2d, is_int8
from npp_tpu_torch.ops.resize import resize_bilinear, scale_output_size
from npp_tpu_torch.parallel.mesh import all_slots, wire
from npp_tpu_torch.parallel.sync_bn import convert_sync_bn

def check_divisibility(batch: int, height: int, n_data: int,
                       n_space: int, target_stride: int = 4) -> None:
    """Raise with a clear message when shapes don't tile onto the mesh."""
    if batch % n_data:
        raise ValueError(f"batch {batch} not divisible by data={n_data}")
    if height % n_space:
        raise ValueError(f"height {height} not divisible by space={n_space}")
    if (height // target_stride) % n_space:
        raise ValueError(
            f"target height {height // target_stride} (stride "
            f"{target_stride}) not divisible by space={n_space}")


# The row axis of each array of a rendered batch (``data/loader.py``):
# NCHW images, (B, H, W) labels and edges, (B, J, h, w) heatmaps.
ROW_DIMS = {"image": 2, "par": 1, "edge": 1, "pose": 2, "pose_aux": 2}


def shard_batch_spatial(batch: dict, grid, *, data_sharded: bool = False
                        ) -> dict:
    """This rank's part of a rendered batch dict (device tensors): data
    shard ``grid.d`` of the batch (contiguous, so the global batch is the
    data shards in order; skipped with ``data_sharded``, as for a
    loader's batch) and row block ``grid.s`` of every image, label, edge
    and heatmap (``ROW_DIMS``). The heatmaps are rendered at full height
    and sliced, so the rows are the full map's. Other entries (joints,
    weights, names) are per-sample and only batch-sharded."""
    image = batch["image"]
    if image.dim() != 4 or image.shape[1] != 3:
        raise ValueError(f"expected NCHW images (B, 3, H, W), got "
                         f"{tuple(image.shape)}")
    n_b = len(image)
    check_divisibility(grid.n_data if data_sharded else n_b, image.shape[2],
                       grid.n_data, grid.n_space)
    b = n_b // grid.n_data
    out = {}
    for k, v in batch.items():
        if not data_sharded:
            v = v[grid.d * b:(grid.d + 1) * b]
        if k in ROW_DIMS:
            h = v.shape[ROW_DIMS[k]] // grid.n_space
            v = v.narrow(ROW_DIMS[k], grid.s * h, h)
        out[k] = v
    return out


# -- collectives with autograd ------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    """The sum over the space group; its gradient is too (every rank's
    result feeds that rank's rows)."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid = grid
        t = wire(x).clone()
        dist.all_reduce(t, group=grid.space_group)
        return t.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        t = wire(g).clone()
        dist.all_reduce(t, group=ctx.grid.space_group)
        return t.to(g.dtype), None


def sum_over_space(x: torch.Tensor, grid) -> torch.Tensor:
    return _AllReduceSum.apply(x, grid)


class _GatherRows(torch.autograd.Function):
    """All rows of the space group's shards (dim -2), in rank order; the
    backward sums the gradient of every rank's copy and keeps the
    owner's rows."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.grid, ctx.h = grid, x.shape[-2]
        # (..., n, h, W)
        buf = all_slots(x, grid.space_group).movedim(0, -3)
        return buf.reshape(x.shape[:-2] + (grid.n_space * ctx.h,
                                           x.shape[-1])).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        t = wire(g).contiguous().clone()
        dist.all_reduce(t, group=ctx.grid.space_group)
        s, h = ctx.grid.s, ctx.h
        return t[..., s * h:(s + 1) * h, :].to(g.dtype), None


def gather_rows(x: torch.Tensor, grid) -> torch.Tensor:
    """The whole image from this rank's rows (autograd)."""
    return _GatherRows.apply(x, grid)


def own_rows(y: torch.Tensor, grid) -> torch.Tensor:
    """This rank's rows of a whole level ``y`` held on every rank of the
    group (slicing: the other rows get no gradient here), or ``y`` itself
    if its height does not divide (the level stays replicated)."""
    g = y.shape[-2]
    if g % grid.n_space:
        return y
    h = g // grid.n_space
    return y[..., grid.s * h:(grid.s + 1) * h, :]


class _HaloRows(torch.autograd.Function):
    """[the ``above`` rows of the rank above, own rows, the ``below`` rows
    of the rank below]; the image's first and last rank get no rows from
    outside the image. The backward adds each halo row's gradient to its
    owner's row."""

    @staticmethod
    def forward(ctx, x, above, below, grid):
        n, s, h = grid.n_space, grid.s, x.shape[2]
        # Slot r: rank r's last ``above`` rows (for r + 1) and first
        # ``below`` rows (for r - 1).
        buf = all_slots(torch.cat([x[:, :, h - above:], x[:, :, :below]],
                                  2), grid.space_group)
        ctx.grid, ctx.above, ctx.below, ctx.h = grid, above, below, h
        ctx.up, ctx.down = s > 0 and above > 0, s < n - 1 and below > 0
        parts = [x]
        if ctx.up:
            parts.insert(0, buf[s - 1][:, :, :above].to(x.dtype))
        if ctx.down:
            parts.append(buf[s + 1][:, :, above:].to(x.dtype))
        return torch.cat(parts, 2)

    @staticmethod
    def backward(ctx, g):
        grid, above, below, h = ctx.grid, ctx.above, ctx.below, ctx.h
        s = grid.s
        a = above if ctx.up else 0
        gx = g[:, :, a:a + h]
        send = wire(g).new_zeros((grid.n_space,) + tuple(gx.shape[:2])
                                  + (above + below, g.shape[3]))
        if ctx.up:  # to the rank above: the gradient of its last rows
            send[s - 1][:, :, :above] = g[:, :, :above]
        if ctx.down:  # to the rank below: that of its first rows
            send[s + 1][:, :, above:] = g[:, :, a + h:]
        dist.all_reduce(send, group=grid.space_group)
        dx = wire(gx).clone()
        dx[:, :, h - above:] += send[s][:, :, :above]
        dx[:, :, :below] += send[s][:, :, above:]
        return dx.to(g.dtype), None, None, None


def halo_rows(x: torch.Tensor, grid, above: int, below: int
              ) -> torch.Tensor:
    """``_HaloRows``; ``above`` and ``below`` at most the shard height
    (one neighbour holds them), the same on every rank."""
    if not above and not below:
        return x
    return _HaloRows.apply(x, above, below, grid)


def resize_sharded(x: torch.Tensor, grid, out_hw: tuple[int, int], *,
                   align_corners: bool) -> torch.Tensor:
    """Bilinear resize of an H-sharded NCHW tensor to the global size
    ``out_hw``: the rows gathered, the whole image resized, this rank's
    output rows kept (``own_rows``)."""
    return own_rows(resize_bilinear(gather_rows(x, grid), out_hw,
                                    align_corners=align_corners), grid)


# -- the converted model's ops ---------------------------------------------


class Sharding:
    """The space axis as a converted model's ops see it: the grid and the
    plan of global input heights, one list per network input height
    (module docstring). Ops reach it through their ``space`` attribute
    and call ``window``, ``mean_hw``, ``resize_scale`` or ``height``."""

    def __init__(self, grid, target_stride: int = 4):
        self.grid = grid
        self.target_stride = target_stride
        self.n = grid.n_space
        self.plans: dict[int, list[int]] = {}
        self._mode = None  # None, "trace" or "run"
        self._calls: list[int] = []
        self._pos = 0

    @property
    def tracing(self) -> bool:
        """Whether the forward running now traces the plan (unsharded, on
        a zero image: nothing it computes is kept)."""
        return self._mode == "trace"

    def is_sharded(self, height: int) -> bool:
        """A level of global ``height`` is split into equal row blocks if
        n divides it, else held whole on every rank of the group."""
        return height % self.n == 0

    def height(self, x: torch.Tensor) -> int | None:
        """The global height of an op's input ``x``, or None while the
        plan is traced (the op then runs as the unsharded one)."""
        if self._mode == "trace":
            self._calls.append(x.shape[-2])
            return None
        if self._mode != "run":
            raise RuntimeError("a spatially converted op ran outside the "
                               "forward of the model convert_spatial "
                               "converted")
        if self._pos >= len(self._calls):
            raise RuntimeError("the sharded forward ran more ops than its "
                               "plan holds")
        g = self._calls[self._pos]
        self._pos += 1
        local = g // self.n if self.is_sharded(g) else g
        if x.shape[-2] != local:
            raise RuntimeError(
                f"op {self._pos - 1} of the sharded forward got {x.shape[-2]}"
                f" rows where its plan has {local} of a {g}-row level")
        return g

    def window(self, x: torch.Tensor, fn, extent: int, stride: int,
               pad: int, *, top: bool = False) -> torch.Tensor:
        """``fn(x)`` for an op whose output row o reads input rows
        [stride * o - pad, stride * o - pad + extent) and pads with its
        own value beyond the image (a conv, a pool, a strided slice).
        Halo rows where each shard's output rows are its own and one
        neighbour holds the rows it reads; else the whole level. With
        ``top``, ``fn(rows, at_top)``: whether those rows begin at the
        image's first row."""
        g = self.height(x)
        call = (lambda t, at_top: fn(t, at_top)) if top else \
            (lambda t, at_top: fn(t))
        if g is None:
            return call(x, True)
        grid = self.grid
        if not self.is_sharded(g):
            return own_rows(call(x, True), grid)
        h = g // self.n
        if h % stride == 0 and \
                (g + 2 * pad - extent) // stride + 1 == g // stride:
            above = -(-pad // stride) * stride
            below = max(0, extent - pad - stride)
            if above <= h and below <= h:
                ext = halo_rows(x, grid, above, below)
                start = max(0, grid.s * h - above)
                j0 = (grid.s * h - start) // stride
                return call(ext, start == 0)[:, :, j0:j0 + h // stride]
        return own_rows(call(gather_rows(x, grid), True), grid)

    def mean_hw(self, x: torch.Tensor) -> torch.Tensor:
        """``x.mean(dim=(2, 3), keepdim=True)`` over the whole image."""
        g = self.height(x)
        if g is None or not self.is_sharded(g):
            return x.mean(dim=(2, 3), keepdim=True)
        total = sum_over_space(x.float().sum(dim=(2, 3), keepdim=True),
                               self.grid)
        return (total / (g * x.shape[3])).to(x.dtype)

    def resize_scale(self, x: torch.Tensor, scale: float, *,
                     align_corners: bool) -> torch.Tensor:
        """``ops.resize.resize_scale`` of the whole image."""
        g = self.height(x)
        out_hw = (scale_output_size(x.shape[-2] if g is None else g, scale),
                  scale_output_size(x.shape[-1], scale))
        if g is not None and self.is_sharded(g):
            return resize_sharded(x, self.grid, out_hw,
                                  align_corners=align_corners)
        y = resize_bilinear(x, out_hw, align_corners=align_corners)
        return y if g is None else own_rows(y, self.grid)

    # -- the plan ----------------------------------------------------------

    def _enter(self, module, args):
        x = args[0]
        full = x.shape[-2] * self.n
        check_divisibility(x.shape[0], full, 1, self.n, self.target_stride)
        if full not in self.plans:
            self.plans[full] = self._trace(module, x, full)
        self._mode, self._calls, self._pos = "run", self.plans[full], 0

    def _exit(self, module, args, output):
        if self._pos != len(self._calls):
            raise RuntimeError(f"the sharded forward ran {self._pos} ops of "
                               f"its plan's {len(self._calls)}")
        self._mode = None

    def _trace(self, module, x, full: int) -> list[int]:
        modes = [(m, m.training) for m in module.modules()]
        self._mode, self._calls = "trace", []
        try:
            module.eval()
            with torch.no_grad():
                module.forward(x.new_zeros((1,) + tuple(x.shape[1:-2])
                                           + (full, x.shape[-1])))
            return self._calls
        finally:
            self._mode = None
            for m, training in modes:
                m.training = training


class ShardedConv2d(nn.Conv2d):
    """``nn.Conv2d`` on H-sharded rows (``space``, ``Sharding.window``)
    and on a channel block (``tp``, ``parallel/tensor.py``: its input
    brought to the layout it reads, ``tp_kind`` None, ``"dense"`` or
    ``"depthwise"`` for a replicated, an output-sharded or a sharded
    depthwise conv); with both None it is ``nn.Conv2d``."""

    space = None
    tp = None
    tp_kind = None

    def forward(self, x):
        if self.tp is not None:
            x = self.tp.conv_input(self, x)
        if self.space is None:
            return super().forward(x)
        return self._windowed(x, functools.partial(nn.Conv2d.forward, self))

    def _windowed(self, x, fn):
        extent = self.dilation[0] * (self.kernel_size[0] - 1) + 1
        return self.space.window(x, fn, extent, self.stride[0],
                                 self.padding[0])


class ShardedInt8Conv2d(ShardedConv2d, Int8Conv2d):
    """A prepared dense conv (``ops/quantize.prepare_int8``) of a model
    split over rows: the int8 conv of the rank's row window
    (``Sharding.window``), its dynamic scale the grid's
    (``Int8Conv2d.scale_group``). ``forward(x, relu=True)`` folds the ReLU
    into the window's quantize: the ReLU commutes with the halo exchange
    (a neighbour's rows are its values) and with the zero padding
    (relu(0) = 0), so the fold stays exact. The plan's trace runs each
    rank's own forward on a zero image and keeps nothing, so it takes no
    collective."""

    def forward(self, x, relu=False):
        return self._windowed(x, lambda t: self._conv_forward(
            t, self.weight, self.bias, relu=relu))

    def _tracing(self) -> bool:
        return self.space.tracing


INT8_CONVS[ShardedConv2d] = ShardedInt8Conv2d


def sharded_conv(conv: nn.Conv2d) -> ShardedConv2d:
    """A ``ShardedConv2d`` holding ``conv``'s parameter tensors."""
    with torch.device("meta"):
        new = ShardedConv2d(conv.in_channels, conv.out_channels,
                            conv.kernel_size, conv.stride, conv.padding,
                            conv.dilation, conv.groups,
                            bias=conv.bias is not None,
                            padding_mode=conv.padding_mode)
    new.weight, new.bias = conv.weight, conv.bias
    return new.train(conv.training)


def _known_modules() -> tuple:
    from npp_tpu_torch.models import augment, cells
    from npp_tpu_torch.ops import primitives as P
    return (augment.NPPNet, augment._Stem, augment._Neck, augment._Head,
            cells.Cell, cells.UpsampleCell, cells.FusionCell, cells.InterOp,
            P.Zero, P.Identity, P.PoolBN, P.ReLUConvBN, P.DilConvS,
            P.SepConv, P.SEBlock, P.FactorizedReduce, P.FacConv,
            P.PooledConv, cells.SiblingConvGroup, cells.SiblingSEGroup,
            cells.SiblingDilGroup, cells.SiblingSepGroup, nn.Conv2d,
            nn.BatchNorm2d, nn.ModuleList)


def convert_spatial(model: nn.Module, grid) -> nn.Module:
    """Make ``model`` (NPPNet, or one of its ops) run on this rank's rows
    of its input, in place, on the model of ``sync_bn.convert_sync_bn``:
    every ``nn.Conv2d`` becomes a ``ShardedConv2d`` and every BN a
    ``SyncBatchNorm`` over ``grid.replica_group`` (the world at
    ``n_model`` 1) holding the same tensors, the
    ops that read across rows get the grid (their ``space``), and the
    model's forward learns its plan at each new input height. Weights and
    state_dict keys stay as they were (the bridge and checkpoints work
    unchanged); a model that is not converted runs as before, bit for
    bit. With ``grid.n_space`` 1 the model is returned as it is. A module
    the conversion does not know raises: its rows would be read wrongly
    and silently. The input's height (and for NPPNet height / 4) must
    divide by ``n_space`` (``check_divisibility``). int8 serving is
    prepared after the split (``ops/quantize.prepare_int8(model, grid)``,
    which makes the ``ShardedInt8Conv2d``); a prepared model is refused."""
    if grid is None or grid.n_space == 1:
        return model
    if getattr(model, "_sharding", None) is not None:
        if model._sharding.grid is not grid:
            raise ValueError("the model is converted for another grid")
        return model
    if is_int8(model):
        raise ValueError("convert_spatial: the int8 serving layout is "
                         "prepared after the split; convert the fp model, "
                         "then prepare_int8(model, grid)")
    known = _known_modules()
    for m in model.modules():
        if not isinstance(m, known):
            raise TypeError(f"convert_spatial does not know "
                            f"{type(m).__name__}")
    # NPPNet's outputs at 1/4 must split too; a lone op's need not.
    sharding = Sharding(grid, 4 if isinstance(model, known[0]) else 1)

    convert_sync_bn(model, grid.replica_group)

    def convert(module):
        for name, child in module.named_children():
            if type(child) is nn.Conv2d:
                setattr(module, name, sharded_conv(child))
            else:
                convert(child)

    convert(model)
    for m in model.modules():
        if hasattr(type(m), "space"):
            m.space = sharding
    model._sharding = sharding
    model.register_forward_pre_hook(sharding._enter)
    model.register_forward_hook(sharding._exit)
    return model

"""VoxelPose's folded 7x7x7 front (`ops/front3d_kernels.py`) on the CPU:
its plain version against the folded `ConvBNRelu`'s library ops, bit for
bit; the wrapper's refusals, which hold the kernel to what it takes; the
weight's packing, element by element; the dispatch, which sends only the
rank-3 bf16 fronts to it; and no launch counted on CPU tensors.  The
kernel itself runs on the card only (`tests/test_torch_cuda.py`).
"""

import pytest
import torch

from faster_voxelpose_tpu_torch.models import blocks
from faster_voxelpose_tpu_torch.ops import front3d_kernels as fk
from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk


def _folded(cin=15, rank=3, dtype=torch.bfloat16, cout=16, seed=0):
    """A folded `ConvBNRelu(cin, cout, 7)` with random weights and
    BatchNorm statistics, in eval mode."""
    torch.manual_seed(seed)
    block = blocks.ConvBNRelu(cin, cout, 7, rank, dtype).eval()
    with torch.no_grad():
        block.conv.weight.normal_(0.0, (2.0 / (cin * 7 ** rank)) ** 0.5)
        block.conv.bias.normal_(0.0, 0.1)
        block.bn.running_mean.normal_(0.0, 0.1)
        block.bn.running_var.uniform_(0.5, 1.5)
        block.bn.weight.uniform_(0.5, 1.5)
        block.bn.bias.normal_(0.0, 0.1)
        blocks.fold_layers(block)
    return block


def _cube(N=2, C=15, X=6, Y=7, Z=5, seed=1):
    """The samplers' cubes as the V2VNet takes them: (N, X, Y, Z, C)
    float32 permuted to (N, C, X, Y, Z)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(N, X, Y, Z, C, generator=gen).permute(0, 4, 1, 2, 3)


@pytest.mark.parametrize("cin", [15, 17])
def test_plain_version_is_the_folded_forward(cin):
    """front3d_plain is the folded forward's own ops (the cast, the conv
    with its bias, ReLU) bit for bit, and the block's forward, which now
    routes through the wrapper, gives the same on the CPU; no launch."""
    block, x = _folded(cin), _cube(C=cin)
    conv = block.conv
    sk.reset_launch_counts()
    want = blocks.conv_folded(conv, x.to(conv.dtype)).relu_()
    got = fk.front3d_plain(x, conv.folded_weight, conv.folded_bias)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 16, 6, 7, 5)
    assert torch.equal(got, want)
    with torch.no_grad():
        assert torch.equal(block(x), want)
    assert torch.equal(fk.front3d(x, conv.folded_weight, conv.folded_bias, conv.front3d_weight),
                       want)
    assert sk.launch_counts()["front3d"] == 0


def test_block_serves_the_kernels_operands():
    """The fold keeps the packed weight beside the folded ones, and the
    served operands over the cube's strides pass every check."""
    conv = _folded().conv
    assert fk.serves(conv)
    assert conv.front3d_weight.shape == (2, 7, 7, 7, 1, 2, 2, 8, 8)
    assert "front3d_weight" not in conv.state_dict()
    for x in (_cube(), _cube(N=1, X=3, Y=2, Z=9)):
        fk.check_inputs(x, conv.folded_weight, conv.folded_bias, conv.front3d_weight)


@pytest.mark.parametrize("cin", [1, 15, 16, 17, 32])
def test_pack_weight_places_every_tap(cin):
    """Element (o, c, dx, dy, dz) of the weight sits at (0, dx, dz, dy,
    c // 16, o // 8, c % 16 // 8, o % 8, c % 8) of the packing and, x and
    z swapped, at (1, dz, dx, dy, ...); the padded channels are zero."""
    w = torch.randn(16, cin, 7, 7, 7, generator=torch.Generator().manual_seed(cin))
    p = fk.pack_weight(w.to(torch.bfloat16)).float()
    chunks = 1 if cin <= 16 else 2
    assert p.shape == (2, 7, 7, 7, chunks, 2, 2, 8, 8) and p.is_contiguous()
    o, c, dx, dy, dz = torch.meshgrid(*(torch.arange(n) for n in w.shape), indexing="ij")
    lanes = (c // 16, o // 8, c % 16 // 8, o % 8, c % 8)
    pad = torch.ones_like(p, dtype=torch.bool)
    for orientation, (a, b) in enumerate(((dx, dz), (dz, dx))):
        assert torch.equal(p[(orientation, a, b, dy) + lanes], w.to(torch.bfloat16).float())
        pad[(orientation, a, b, dy) + lanes] = False
    assert not p[pad].any() and int(pad.sum()) == 2 * 16 * 343 * (16 * chunks - cin)


@pytest.mark.parametrize("shape, orientation", [((64, 64, 64), 0), ((80, 80, 20), 1),
                                                ((20, 80, 80), 0), ((9, 13, 11), 0),
                                                ((16, 8, 4), 1), ((4, 8, 16), 0)])
def test_orientation_takes_the_fewer_padded_voxels(shape, orientation):
    """The CPN's 80 x 80 x 20 runs with x and z swapped (no ragged z
    tile); the PRN's cubes and ties run as they are."""
    assert fk._orientation(*shape) == orientation


def _operands(cin=15):
    conv = _folded(cin).conv
    return _cube(C=cin), conv.folded_weight, conv.folded_bias, conv.front3d_weight


@pytest.mark.parametrize("case, error", [
    ("rank_2", ValueError), ("channels_33", ValueError), ("cout_8", ValueError),
    ("float16_weight", TypeError), ("float32_weight", TypeError), ("float64_x", TypeError),
    ("kernel_5", ValueError), ("unpacked", ValueError), ("packed_for_17", ValueError),
    ("requires_grad", ValueError), ("weight_requires_grad", ValueError), ("empty", ValueError),
])
def test_wrapper_refusals(case, error):
    """What the kernel does not take, the wrapper refuses before a launch:
    a rank other than 3, more than 32 channels, other than 16 outputs, a
    dtype other than bf16 weights over a float32 cube, another kernel
    size, a weight not packed for its channels, an input that requires
    grad, an empty cube."""
    x, w, b, p = _operands()
    if case == "rank_2":
        x = x[:, :, 0]
    elif case == "channels_33":
        x, w, b, p = _cube(C=33), torch.zeros(16, 33, 7, 7, 7, dtype=w.dtype), b, p
    elif case == "cout_8":
        w, b = w[:8], b[:8]
    elif case == "float16_weight":
        w, b, p = w.half(), b.half(), p.half()
    elif case == "float32_weight":
        w, b, p = w.float(), b.float(), p.float()
    elif case == "float64_x":
        x = x.double()
    elif case == "kernel_5":
        w = w[..., 1:6, 1:6, 1:6]
    elif case == "unpacked":
        p = w
    elif case == "packed_for_17":
        p = _operands(17)[3]
    elif case == "requires_grad":
        x = x.clone().requires_grad_()
    elif case == "weight_requires_grad":
        w = w.clone().requires_grad_()
    elif case == "empty":
        x = x[:, :, :0]
    with pytest.raises(error):
        fk.check_inputs(x, w, b, p)


@pytest.mark.parametrize("cin", [15, 17])
def test_dispatch_keeps_rank_2_fronts_on_their_path(cin, monkeypatch):
    """The rank-2 fronts of CenterNet, C2CNet and P2PNet (7x7, 15 or 17
    joints) and a float32 rank-3 front keep their old ops, bit for bit,
    and never reach the wrapper; the bf16 rank-3 front reaches it once a
    forward."""
    calls = []
    kernel = fk.front3d

    def spy(*args):
        calls.append(args[0].shape)
        return kernel(*args)

    monkeypatch.setattr(fk, "front3d", spy)
    sk.reset_launch_counts()
    for rank, dtype in ((2, torch.bfloat16), (3, torch.float32)):
        block = _folded(cin, rank, dtype)
        assert not fk.serves(block.conv) and "front3d_weight" not in block.conv._buffers
        x = _cube(C=cin)[..., 0] if rank == 2 else _cube(C=cin)
        with torch.no_grad():
            got = block(x)
        want = blocks.conv_folded(block.conv, x.to(dtype)).relu_()
        assert torch.equal(got, want)
    assert calls == [] and sk.launch_counts()["front3d"] == 0
    with torch.no_grad():
        _folded(cin)(_cube(C=cin))
    assert calls == [(2, cin, 6, 7, 5)] and sk.launch_counts()["front3d"] == 0


def test_refold_copies_into_the_packed_buffer():
    """A refold after the weight moved writes the new packing into the
    buffer of the first fold, so that a captured graph reads it."""
    block = _folded()
    before = block.conv.front3d_weight
    ptr = before.data_ptr()
    with torch.no_grad():
        block.conv.weight.mul_(-1.0)
        blocks.fold_layers(block)
    after = block.conv.front3d_weight
    assert after is before and after.data_ptr() == ptr
    assert torch.equal(after, fk.pack_weight(block.conv.folded_weight))


def test_only_voxelpose_fronts_take_the_kernel():
    """Folded, VoxelPose's CPN and PRN fronts keep a packed weight and no
    other conv does; Faster VoxelPose's folded fusion model has none."""
    from faster_voxelpose_tpu_torch.models import build_fusion_model
    from faster_voxelpose_tpu_torch.tools.dryrun_multichip import tiny_config

    cfg = tiny_config()
    cfg.NETWORK.COMPUTE_DTYPE = "bfloat16"
    fvp = build_fusion_model(cfg).eval().fold()
    assert not [n for n, m in fvp.named_modules() if "front3d_weight" in m._buffers]
    cfg.MODEL = "voxelpose"
    vp = build_fusion_model(cfg).fold()
    assert sorted(n for n, m in vp.named_modules() if "front3d_weight" in m._buffers) == [
        "cpn.front.front_basic.conv", "prn.front.front_basic.conv"]

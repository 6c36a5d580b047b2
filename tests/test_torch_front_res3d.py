"""The head of VoxelPose's folded `front_res` block
(`ops/front_res3d_kernels.py`) on the CPU: its plain version against the
folded `ResBlock`'s library ops, bit for bit; the weights' packing,
element by element; the wrapper's refusals, which hold the kernel to what
it takes; the dispatch, which sends only the rank-3 bf16 `ResBlock(16,
32)` to it; a refold into the packed buffer; and no launch counted on CPU
tensors.  The kernel itself runs on the card only
(`tests/test_torch_cuda.py`).
"""

import pytest
import torch

from faster_voxelpose_tpu_torch.models import blocks
from faster_voxelpose_tpu_torch.ops import front_res3d_kernels as rk
from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk


def _folded(cin=16, cout=32, rank=3, dtype=torch.bfloat16, seed=0):
    """A folded `ResBlock(cin, cout)` with random weights and BatchNorm
    statistics, in eval mode."""
    torch.manual_seed(seed)
    block = blocks.ResBlock(cin, cout, rank, dtype).eval()
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, blocks.Conv):
                m.weight.normal_(0.0, (2.0 / m.weight[0].numel()) ** 0.5)
                m.bias.normal_(0.0, 0.1)
            elif isinstance(m, blocks.BatchNorm):
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0.0, 0.1)
        blocks.fold_layers(block)
    return block


def _x(N=2, X=6, Y=7, Z=5, C=16, rank=3, dtype=torch.bfloat16, seed=1):
    """front3d's output as the block takes it: (N, C, *spatial) in the
    compute dtype, channels last, ReLU'd values."""
    gen = torch.Generator().manual_seed(seed)
    spatial = (X, Y, Z)[:rank]
    x = torch.rand(N, *spatial, C, generator=gen).to(dtype)
    return x.permute(0, rank + 1, *range(1, rank + 1))


def _old_forward(block, x):
    """The folded block's forward before the kernel: cuDNN's ops' CPU
    counterparts (conv1 + bias + ReLU, the skip + bias, conv2 + shortcut
    + ReLU)."""
    h = blocks.conv_folded(block.conv1, x).relu_()
    skip = blocks.conv_folded(block.skip_conv, x) if block.project else x
    return h, skip, blocks.conv_folded(block.conv2, h).add_(skip).relu_()


@pytest.mark.parametrize("shape", [(2, 6, 7, 5), (1, 9, 4, 17)])
def test_plain_version_is_the_folded_forward(shape):
    """front_res3d_plain is the folded forward's own ops bit for bit, and
    the block's forward, which now routes through the wrapper, gives the
    same on the CPU; no launch."""
    block, x = _folded(), _x(*shape)
    c1, skc = block.conv1, block.skip_conv
    h, s, out = _old_forward(block, x)
    sk.reset_launch_counts()
    got_h, got_s = rk.front_res3d_plain(x, c1.folded_weight, c1.folded_bias, skc.folded_weight,
                                        skc.folded_bias)
    assert got_h.dtype == got_s.dtype == torch.bfloat16
    assert got_h.shape == got_s.shape == (shape[0], 32) + shape[1:]
    assert torch.equal(got_h, h) and torch.equal(got_s, s)
    assert all(torch.equal(a, b) for a, b in zip(
        rk.front_res3d(x, c1.folded_weight, c1.folded_bias, skc.folded_weight, skc.folded_bias,
                       block.front_res3d_weight), (h, s)))
    with torch.no_grad():
        assert torch.equal(block(x), out)
    assert sk.launch_counts()["front_res3d"] == 0


def test_block_serves_the_kernels_operands():
    """The fold keeps the packed weights beside the folded ones, out of the
    state dict, and the served operands pass every check, over front3d's
    layout and over a plain contiguous one."""
    block = _folded()
    assert rk.serves(block)
    assert block.front_res3d_weight.shape == (2, 28, 4, 2, 8, 8)
    assert "front_res3d_weight" not in block.state_dict()
    c1, skc = block.conv1, block.skip_conv
    for x in (_x(), _x(N=1, X=3, Y=2, Z=9).contiguous()):
        rk.check_inputs(x, c1.folded_weight, c1.folded_bias, skc.folded_weight, skc.folded_bias,
                        block.front_res3d_weight)
    assert rk._kernel_layout(_x()) and not rk._kernel_layout(_x().contiguous())


@pytest.mark.parametrize("orientation", [0, 1])
def test_pack_weight_places_every_tap(orientation):
    """Element (o, c, dx, dy, dz) of conv1 sits at (orientation, (a * 3 +
    b) * 3 + dy, o // 8, c // 8, o % 8, c % 8) with (a, b) = (dx, dz), or
    (dz, dx) with x and z swapped; element (o, c) of the skip at tap 27 of
    both; nothing else is in the packing."""
    gen = torch.Generator().manual_seed(orientation)
    w1 = torch.randn(32, 16, 3, 3, 3, generator=gen).to(torch.bfloat16)
    ws = torch.randn(32, 16, 1, 1, 1, generator=gen).to(torch.bfloat16)
    p = rk.pack_weight(w1.contiguous(memory_format=torch.channels_last_3d), ws)
    assert p.shape == (2, 28, 4, 2, 8, 8) and p.is_contiguous() and p.dtype == torch.bfloat16
    o, c, dx, dy, dz = torch.meshgrid(*(torch.arange(n) for n in w1.shape), indexing="ij")
    a, b = (dx, dz) if orientation == 0 else (dz, dx)
    lanes = (o // 8, c // 8, o % 8, c % 8)
    assert torch.equal(p[(orientation, (a * 3 + b) * 3 + dy) + lanes], w1)
    o, c = torch.meshgrid(torch.arange(32), torch.arange(16), indexing="ij")
    assert torch.equal(p[(orientation, torch.full_like(o, 27)) + (o // 8, c // 8, o % 8, c % 8)],
                       ws[:, :, 0, 0, 0])
    # every element placed once: the packing holds each value's multiset
    assert torch.equal(p[orientation].flatten().float().sort().values,
                       torch.cat([w1.flatten(), ws.flatten()]).float().sort().values)


def _operands():
    block = _folded()
    c1, skc = block.conv1, block.skip_conv
    return [_x(), c1.folded_weight, c1.folded_bias, skc.folded_weight, skc.folded_bias,
            block.front_res3d_weight]


def _misaligned(t):
    """t's values in a contiguous tensor that starts 2 bytes past 16."""
    buf = torch.zeros(t.numel() + 8, dtype=t.dtype)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("case, error", [
    ("float32_x", TypeError), ("float16_weight", TypeError), ("float32_bias", TypeError),
    ("rank_2", ValueError), ("channels_15", ValueError), ("channels_32", ValueError),
    ("cout_16", ValueError), ("kernel_5", ValueError), ("unpacked", ValueError),
    ("strided_bias", ValueError), ("misaligned_packing", ValueError),
    ("requires_grad", ValueError), ("weight_requires_grad", ValueError),
    ("two_devices", ValueError), ("empty", ValueError),
])
def test_wrapper_refusals(case, error):
    """What the kernel does not take, the wrapper refuses before a launch:
    a dtype other than bf16, a rank other than 3, other than 16 channels
    in or 32 out, another kernel size, weights not packed by `pack_weight`
    or packed off 16 bytes, a strided bias, an input that requires grad,
    operands on two devices, an empty cube."""
    ops = _operands()
    x, w1, b1, ws, bs, p = ops
    if case == "float32_x":
        ops[0] = x.float()
    elif case == "float16_weight":
        ops[1] = w1.half()
    elif case == "float32_bias":
        ops[4] = bs.float()
    elif case == "rank_2":
        ops[0] = x[:, :, 0]
    elif case == "channels_15":
        ops[0] = x[:, :15]
    elif case == "channels_32":
        ops[0] = torch.cat([x, x], 1)
    elif case == "cout_16":
        ops[1], ops[2], ops[3], ops[4] = w1[:16], b1[:16], ws[:16], bs[:16]
    elif case == "kernel_5":
        ops[1] = torch.zeros(32, 16, 5, 5, 5, dtype=w1.dtype)
    elif case == "unpacked":
        ops[5] = p[0]
    elif case == "strided_bias":
        ops[2] = torch.stack([b1, b1], 1)[:, 0]
    elif case == "misaligned_packing":
        ops[5] = _misaligned(p)
    elif case == "requires_grad":
        ops[0] = x.float().requires_grad_().to(torch.bfloat16)
    elif case == "weight_requires_grad":
        ops[1] = w1.clone().requires_grad_()
    elif case == "two_devices":
        ops[5] = torch.empty(p.shape, dtype=p.dtype, device="meta")
    elif case == "empty":
        ops[0] = x[:, :, :0]
    with pytest.raises(error):
        rk.check_inputs(*ops)


@pytest.mark.parametrize("rank, cin, cout, dtype", [
    (2, 16, 32, torch.bfloat16), (1, 16, 32, torch.bfloat16), (3, 16, 32, torch.float32),
    (3, 32, 32, torch.bfloat16), (3, 32, 64, torch.bfloat16), (3, 8, 16, torch.bfloat16),
])
def test_dispatch_keeps_other_blocks_on_their_path(rank, cin, cout, dtype, monkeypatch):
    """The rank-2 and rank-1 `ResBlock(16, 32)`s of P2PNet, CenterNet and
    C2CNet, a float32 rank-3 one, the `EncoderDecoder`'s 32 -> 32 and 32 ->
    64 blocks and a half-width front keep their old ops, bit for bit, and
    never reach the wrapper."""
    calls = []
    monkeypatch.setattr(rk, "front_res3d", lambda *a: calls.append(a))
    block = _folded(cin, cout, rank, dtype)
    assert not rk.serves(block) and "front_res3d_weight" not in block._buffers
    x = _x(C=cin, rank=rank, dtype=dtype)
    with torch.no_grad():
        assert torch.equal(block(x), _old_forward(block, x)[2])
    assert calls == []


def test_dispatch_sends_the_served_block_once(monkeypatch):
    """The bf16 rank-3 `ResBlock(16, 32)` reaches the wrapper once a
    forward, with its folded operands and its packing."""
    calls = []
    kernel = rk.front_res3d

    def spy(*args):
        calls.append(args)
        return kernel(*args)

    monkeypatch.setattr(rk, "front_res3d", spy)
    block, x = _folded(), _x()
    with torch.no_grad():
        block(x)
    assert len(calls) == 1 and calls[0][0] is x
    assert calls[0][1] is block.conv1.folded_weight and calls[0][5] is block.front_res3d_weight


def test_refold_copies_into_the_packed_buffer():
    """A refold after the weights moved writes the new packing into the
    buffer of the first fold, so that a captured graph reads it."""
    block = _folded()
    before = block.front_res3d_weight
    ptr = before.data_ptr()
    with torch.no_grad():
        block.conv1.weight.mul_(-1.0)
        block.skip_bn.running_mean.fill_(0.3)
        blocks.fold_layers(block)
    after = block.front_res3d_weight
    assert after is before and after.data_ptr() == ptr
    assert torch.equal(after, rk.pack_weight(block.conv1.folded_weight,
                                             block.skip_conv.folded_weight))


def test_only_voxelpose_front_res_takes_the_kernel():
    """Folded, VoxelPose's CPN and PRN `front_res` blocks keep a packed
    weight and no other block does; Faster VoxelPose's folded fusion
    model, whose nets hold `ResBlock(16, 32)` at ranks 2 and 1, has
    none."""
    from faster_voxelpose_tpu_torch.models import build_fusion_model
    from faster_voxelpose_tpu_torch.tools.dryrun_multichip import tiny_config

    cfg = tiny_config()
    cfg.NETWORK.COMPUTE_DTYPE = "bfloat16"
    fvp = build_fusion_model(cfg).eval().fold()
    heads = [m for m in fvp.modules() if isinstance(m, blocks.ResBlock) and m.project
             and m.conv1.weight.shape[:2] == (32, 16)]
    assert sorted({m.conv1.rank for m in heads}) == [1, 2]
    assert not [n for n, m in fvp.named_modules() if "front_res3d_weight" in m._buffers]
    cfg.MODEL = "voxelpose"
    vp = build_fusion_model(cfg).fold()
    assert sorted(n for n, m in vp.named_modules() if "front_res3d_weight" in m._buffers) == [
        "cpn.front.front_res", "prn.front.front_res"]

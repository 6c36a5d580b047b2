"""WeightNet's folded front (`ops/weightnet_kernels.py`) on the CPU: the
wrapper's refusals, which hold the kernel to what it takes; its plain
version, which the CPU runs, against the folded library chain it stands
for (bit for bit: the same ops); and no launch counted on CPU tensors.
The kernel itself runs on the card only (`tests/test_torch_cuda.py`).
"""

import pytest
import torch
import torch.nn.functional as F

from faster_voxelpose_tpu_torch.models import blocks
from faster_voxelpose_tpu_torch.models.cnns import WeightNet
from faster_voxelpose_tpu_torch.ops import sampling_kernels as sk
from faster_voxelpose_tpu_torch.ops import weightnet_kernels as wk


def _folded(dtype, channels=32, seed=0):
    """A WeightNet with random weights and BatchNorm statistics, folded
    (`blocks.fold_layers`), in eval mode."""
    torch.manual_seed(seed)
    net = WeightNet(channels, 64, dtype=dtype).eval()
    with torch.no_grad():
        net.feat_conv.weight.normal_(0.0, (2.0 / 9) ** 0.5)
        net.feat_conv.bias.normal_(0.0, 0.1)
        net.feat_bn.running_mean.normal_(0.0, 0.1)
        net.feat_bn.running_var.uniform_(0.5, 1.5)
        net.feat_bn.weight.uniform_(0.5, 1.5)
        net.feat_bn.bias.normal_(0.0, 0.1)
        blocks.fold_layers(net)
    return net


def _feats(M=3, J=15, H=16, W=16, seed=1):
    """P2PNet's output layout: (M, J, H, W) channels-last float32."""
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(M, H, W, J, generator=gen).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_plain_version_is_the_folded_library_chain(dtype):
    """The CPU path: the input cast, the folded conv with its bias and
    ReLU (`blocks.conv_relu`), the 2x2 max pool and the mean, bit for bit;
    no launch counted."""
    net = _folded(dtype)
    conv, x = net.feat_conv, _feats()
    M, J, H, W = x.shape
    sk.reset_launch_counts()
    got = wk.weightnet_front(x, conv.folded_weight, conv.folded_bias)
    chain = blocks.conv_relu(conv, x.reshape(M * J, 1, H, W).to(conv.dtype))
    want = F.max_pool2d(chain, 2).mean(dim=(2, 3))
    assert got.dtype == dtype and torch.equal(got, want)
    with torch.no_grad():
        net(x)
    assert sk.launch_counts()["weightnet_front"] == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_kernel_takes_the_served_operands(dtype):
    """The folded weight (channels-last (32, 1, 3, 3)) and bias of the
    served net, over P2PNet's channels-last feats and a strided slice of
    them, pass every check of the wrapper."""
    conv = _folded(dtype).feat_conv
    for x in (_feats(), _feats(M=2, J=30)[:, ::2]):
        wk.check_inputs(x, conv.folded_weight, conv.folded_bias)


def _operands(H=16, W=16, C=32, dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(2)
    w = torch.randn(C, 1, 3, 3, generator=gen).to(dtype)
    return _feats(H=H, W=W), w, torch.randn(C, generator=gen).to(dtype)


@pytest.mark.parametrize("case, error", [
    ("odd_h", ValueError), ("odd_w", ValueError), ("channels_65", ValueError),
    ("float16_weight", TypeError), ("float64_feats", TypeError), ("bias_dtype", TypeError),
    ("weight_5x5", ValueError), ("two_input_channels", ValueError), ("3d_feats", ValueError),
    ("transposed_weight", ValueError), ("requires_grad", ValueError),
])
def test_wrapper_refusals(case, error):
    """What the kernel does not take, the wrapper refuses before a launch:
    odd map sides, more than 64 channels, a dtype other than float32 or
    bf16 (or a float32 input), another kernel shape, weights that are not
    9 * o + 3 * kh + kw in memory, an input that requires grad."""
    x, w, b = _operands()
    if case == "odd_h":
        x = _feats(H=15)
    elif case == "odd_w":
        x = _feats(W=17)
    elif case == "channels_65":
        x, w, b = _operands(C=65)
    elif case == "float16_weight":
        w, b = w.half(), b.half()
    elif case == "float64_feats":
        x = x.double()
    elif case == "bias_dtype":
        b = b.float()
    elif case == "weight_5x5":
        w = torch.zeros(32, 1, 5, 5, dtype=w.dtype)
    elif case == "two_input_channels":
        w = torch.zeros(32, 2, 3, 3, dtype=w.dtype)
    elif case == "3d_feats":
        x = x[0]
    elif case == "transposed_weight":
        w = w.transpose(2, 3)
    elif case == "requires_grad":
        x = x.clone().requires_grad_()
    with pytest.raises(error):
        wk.check_inputs(x, w, b)


def test_refusals_leave_the_plain_cpu_path_alone():
    """On CPU tensors the wrapper runs the plain version, which pools
    odd sides as `F.max_pool2d` does; nothing is launched or counted."""
    x, w, b = _operands()
    x = _feats(H=15, W=17)
    sk.reset_launch_counts()
    out = wk.weightnet_front(x, w, b)
    assert out.shape == (3 * 15, 32) and sk.launch_counts()["weightnet_front"] == 0

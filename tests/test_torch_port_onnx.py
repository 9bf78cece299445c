"""The port's ONNX interpreter (eval/onnx_torch.py) against the JAX package's
(eval/onnx_jax.py), on graphs that tests/onnx_writer.py builds: one case per
op family of tests/test_onnx_golden.py, the attributes where the two could
part (explicit and SAME pads, ``-inf`` pool padding, Slice sentinels and
negative steps, Cast codes, Constant, optional inputs), every
NotImplementedError case, a DNSMOS-trunk-shaped graph and the two DNSMOS
stand-ins at the real graphs' interfaces.

Each graph goes through both ``OnnxModel``s on the same seeded numpy
inputs. Tolerances: float outputs within 1e-5 (f32 in another order);
integer and shape ops exact, the shapes equal.
"""

import numpy as np
import pytest
import torch

from dl_speech_enhancement_tpu.eval import onnx_jax
from dl_speech_enhancement_tpu_torch.eval import onnx_torch
import onnx_writer as ow
from torch_port_threads import one_thread  # noqa: F401

ATOL = 1e-5


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _both(tmp_path, nodes, inits, inputs, outputs, *feeds):
    """Run the graph through both interpreters; check and return the port's
    outputs as numpy."""
    path = ow.write_model(tmp_path / "m.onnx", nodes, inits, inputs, outputs)
    want = [_np(o) for o in onnx_jax.OnnxModel(path)(*feeds)]
    got = [_np(o) for o in onnx_torch.OnnxModel(path, device="cpu")(*feeds)]
    assert len(got) == len(want)
    for name, g, w in zip(outputs, got, want):
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.floating):
            assert np.issubdtype(g.dtype, np.floating), name
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=name)
        else:
            assert np.array_equal(g, w), name
    return got


def _raise_in_both(tmp_path, nodes, inits, inputs, outputs, *feeds):
    path = ow.write_model(tmp_path / "m.onnx", nodes, inits, inputs, outputs)
    with pytest.raises(NotImplementedError):
        onnx_jax.OnnxModel(path)(*feeds)
    with pytest.raises(NotImplementedError):
        onnx_torch.OnnxModel(path, device="cpu")(*feeds)


def test_conv2d_valid_strided_bias(rng, tmp_path):
    x = rng.standard_normal((2, 3, 16, 12)).astype(np.float32)
    _both(tmp_path, [ow.node("Conv", ["x", "w", "b"], ["y"], strides=[2, 2],
                             auto_pad=b"VALID")],
          {"w": rng.standard_normal((5, 3, 3, 3)).astype(np.float32),
           "b": rng.standard_normal((5,)).astype(np.float32)}, ["x"], ["y"], x)


def test_conv2d_explicit_asymmetric_pads(rng, tmp_path):
    x = rng.standard_normal((1, 2, 9, 7)).astype(np.float32)
    _both(tmp_path, [ow.node("Conv", ["x", "w"], ["y"], pads=[1, 0, 2, 1])],
          {"w": rng.standard_normal((4, 2, 3, 2)).astype(np.float32)}, ["x"], ["y"], x)


@pytest.mark.parametrize("mode", ["SAME_UPPER", "SAME_LOWER"])
def test_conv2d_same_auto_pad(rng, tmp_path, mode):
    x = rng.standard_normal((1, 1, 10, 9)).astype(np.float32)
    (y,) = _both(tmp_path, [ow.node("Conv", ["x", "w"], ["y"], strides=[2, 2],
                                    dilations=[1, 2], auto_pad=mode.encode())],
                 {"w": rng.standard_normal((2, 1, 4, 3)).astype(np.float32)}, ["x"], ["y"], x)
    assert y.shape == (1, 2, 5, 5)


def test_conv1d_dilated_grouped(rng, tmp_path):
    x = rng.standard_normal((2, 4, 32)).astype(np.float32)
    _both(tmp_path, [ow.node("Conv", ["x", "w", "b"], ["y"], dilations=[2], group=2,
                             pads=[3, 1])],
          {"w": rng.standard_normal((6, 2, 5)).astype(np.float32),
           "b": rng.standard_normal((6,)).astype(np.float32)}, ["x"], ["y"], x)


def test_maxpool_pads(rng, tmp_path):
    """Symmetric, asymmetric and above half the kernel: -inf padding."""
    x = rng.standard_normal((2, 3, 11, 13)).astype(np.float32) - 5.0
    _both(tmp_path,
          [ow.node("MaxPool", ["x"], ["a"], kernel_shape=[3, 2], strides=[2, 2],
                   pads=[1, 0, 1, 0]),
           ow.node("MaxPool", ["x"], ["b"], kernel_shape=[3, 3], strides=[1, 2],
                   pads=[2, 0, 0, 2]),
           ow.node("MaxPool", ["x"], ["c"], kernel_shape=[2, 3])],
          {}, ["x"], ["a", "b", "c"], x)


def test_maxpool_1d(rng, tmp_path):
    x = rng.standard_normal((2, 3, 17)).astype(np.float32)
    _both(tmp_path, [ow.node("MaxPool", ["x"], ["y"], kernel_shape=[3], strides=[2],
                             pads=[1, 2])], {}, ["x"], ["y"], x)


def test_avgpool_and_global(rng, tmp_path):
    x = rng.standard_normal((2, 3, 12, 8)).astype(np.float32)
    _both(tmp_path,
          [ow.node("AveragePool", ["x"], ["a"], kernel_shape=[2, 3], strides=[2, 1]),
           ow.node("GlobalAveragePool", ["a"], ["y"])],
          {}, ["x"], ["a", "y"], x)


def test_matmul_and_gemm(rng, tmp_path):
    x = rng.standard_normal((3, 7)).astype(np.float32)
    _both(tmp_path,
          [ow.node("MatMul", ["x", "w"], ["m"]),
           ow.node("Gemm", ["m", "wg", "b"], ["y"], transB=1, alpha=0.5, beta=2.0),
           ow.node("Gemm", ["wt", "m"], ["z"], transA=1)],
          {"w": rng.standard_normal((7, 5)).astype(np.float32),
           "wg": rng.standard_normal((4, 5)).astype(np.float32),
           "b": rng.standard_normal((4,)).astype(np.float32),
           "wt": rng.standard_normal((3, 2)).astype(np.float32)},
          ["x"], ["m", "y", "z"], x)


def test_elementwise_chain(rng, tmp_path):
    """The P.835 head's chain, and the unary activations."""
    x = np.abs(rng.standard_normal((2, 6)).astype(np.float32)) + 0.5
    ops = [ow.node("Pow", ["x", "c"], ["p"]), ow.node("Sqrt", ["p"], ["s"]),
           ow.node("Log", ["s"], ["l"]), ow.node("Exp", ["l"], ["e"]),
           ow.node("Neg", ["e"], ["n"]), ow.node("Abs", ["n"], ["a"]),
           ow.node("Div", ["a", "c"], ["d"]), ow.node("Mul", ["d", "c"], ["m"]),
           ow.node("Sub", ["m", "c"], ["sub"]), ow.node("Add", ["sub", "c"], ["add"]),
           ow.node("Max", ["add", "c"], ["mx"]), ow.node("Min", ["mx", "x"], ["mn"]),
           ow.node("Sigmoid", ["mn"], ["sg"]), ow.node("Tanh", ["sg"], ["th"]),
           ow.node("Relu", ["n"], ["r"]), ow.node("Identity", ["th"], ["y"]),
           ow.node("Dropout", ["y"], ["dr"])]
    _both(tmp_path, ops, {"c": np.full((1,), 2.0, np.float32)}, ["x"],
          ["mn", "r", "y", "dr"], x)


def test_shape_ops(rng, tmp_path):
    x = rng.standard_normal((2, 3, 4)).astype(np.float32)
    _both(tmp_path,
          [ow.node("Transpose", ["x"], ["t"], perm=[2, 0, 1]),
           ow.node("Transpose", ["x"], ["tr"]),
           ow.node("Reshape", ["t", "shape"], ["r"]),
           ow.node("Unsqueeze", ["r"], ["u"], axes=[0, -1]),
           ow.node("Squeeze", ["u"], ["s"], axes=[0]),
           ow.node("Unsqueeze", ["s", "ax"], ["u2"]),
           ow.node("Squeeze", ["u2", "ax"], ["s2"]),
           ow.node("Squeeze", ["u"], ["s3"]),
           ow.node("Concat", ["s2", "s2"], ["c"], axis=1),
           ow.node("Flatten", ["c"], ["y"], axis=2)],
          {"shape": np.asarray([4, -1], np.int64), "ax": np.asarray([1], np.int64)}, ["x"],
          ["t", "tr", "r", "u", "s2", "s3", "c", "y"], x)


@pytest.mark.parametrize("case", [
    ([1], [4], [0], [1]), ([-3], [ow.INT64_MAX], [1], [1]), ([0], [100], [0], [2]),
    ([ow.INT64_MAX], [ow.INT64_MIN], [0], [-1]), ([4], [1], [1], [-2]),
    ([-1, 5], [-7, 0], [1, 0], [-3, -2]), ([2], [-1], [-1], [1])],
    ids=["plain", "neg-start", "past-end", "reverse", "neg-step", "two-axes", "neg-axis"])
def test_slice_semantics(rng, tmp_path, case):
    """Negative indices, the INT64 sentinels, negative steps."""
    x = rng.standard_normal((6, 8)).astype(np.float32)
    starts, ends, axes, steps = (np.asarray(v, np.int64) for v in case)
    _both(tmp_path, [ow.node("Slice", ["x", "st", "en", "ax", "sp"], ["y"])],
          {"st": starts, "en": ends, "ax": axes, "sp": steps}, ["x"], ["y"], x)


def test_slice_without_axes_and_steps(rng, tmp_path):
    x = rng.standard_normal((5, 7)).astype(np.float32)
    _both(tmp_path, [ow.node("Slice", ["x", "st", "en"], ["y"])],
          {"st": np.asarray([1, 2], np.int64), "en": np.asarray([4, -1], np.int64)},
          ["x"], ["y"], x)


def test_reduce_softmax_clip_cast(rng, tmp_path):
    x = rng.standard_normal((3, 5, 4)).astype(np.float32)
    _both(tmp_path,
          [ow.node("ReduceMax", ["x"], ["rm"], axes=[1], keepdims=1),
           ow.node("ReduceMax", ["x"], ["rall"], keepdims=0),
           ow.node("ReduceMean", ["x"], ["rme"], axes=[2], keepdims=0),
           ow.node("ReduceMean", ["x", "axes"], ["rin"]),
           ow.node("Softmax", ["rme"], ["sm"], axis=-1),
           ow.node("Clip", ["x", "lo", "hi"], ["cl"]),
           ow.node("Clip", ["x", "", "hi"], ["hi_only"]),
           ow.node("Clip", ["x", "lo"], ["lo_only"]),
           ow.node("Cast", ["x"], ["ci"], to=6),
           ow.node("Cast", ["ci"], ["cf"], to=1),
           ow.node("Cast", ["x"], ["bf"], to=16),
           ow.node("Cast", ["x"], ["hf"], to=10)],
          {"lo": np.float32(-0.5), "hi": np.float32(0.5),
           "axes": np.asarray([0, 2], np.int64)},
          ["x"], ["rm", "rall", "rme", "rin", "sm", "cl", "hi_only", "lo_only", "ci", "cf",
                  "bf", "hf"], x)


def test_constants(rng, tmp_path):
    """A Constant operand (the JAX interpreter traces a Constant under jit,
    so a shape comes from an initializer)."""
    x = rng.standard_normal((2, 12)).astype(np.float32)
    _both(tmp_path,
          [ow.node("Constant", [], ["k"], value=np.full((1, 12), 0.5, np.float32)),
           ow.node("Mul", ["x", "k"], ["m"]),
           ow.node("Reshape", ["m", "shape"], ["y"])],
          {"shape": np.asarray([2, 3, -1], np.int64)}, ["x"], ["m", "y"], x)


def test_dnsmos_trunk_graph(rng, tmp_path):
    """conv / relu / maxpool x 2 -> transpose -> reshape -> matmul + add ->
    relu -> reduce, the DNSMOS CNN trunk's shape."""
    x = rng.standard_normal((2, 1, 24, 20)).astype(np.float32)
    _both(tmp_path,
          [ow.node("Conv", ["x", "w1", "b1"], ["c1"], auto_pad=b"VALID"),
           ow.node("Relu", ["c1"], ["r1"]),
           ow.node("MaxPool", ["r1"], ["p1"], kernel_shape=[2, 2], strides=[2, 2]),
           ow.node("Conv", ["p1", "w2", "b2"], ["c2"], auto_pad=b"VALID"),
           ow.node("Relu", ["c2"], ["r2"]),
           ow.node("MaxPool", ["r2"], ["p2"], kernel_shape=[2, 2], strides=[2, 2]),
           ow.node("Transpose", ["p2"], ["t"], perm=[0, 2, 3, 1]),
           ow.node("Reshape", ["t", "shape"], ["f"]),
           ow.node("MatMul", ["f", "wd"], ["d"]),
           ow.node("Add", ["d", "bd"], ["da"]),
           ow.node("Relu", ["da"], ["dr"]),
           ow.node("ReduceMax", ["dr"], ["y"], axes=[1], keepdims=0)],
          {"w1": (rng.standard_normal((8, 1, 3, 3)) * 0.3).astype(np.float32),
           "b1": (rng.standard_normal((8,)) * 0.1).astype(np.float32),
           "w2": (rng.standard_normal((4, 8, 3, 3)) * 0.3).astype(np.float32),
           "b2": (rng.standard_normal((4,)) * 0.1).astype(np.float32),
           "wd": (rng.standard_normal((48, 6)) * 0.2).astype(np.float32),
           "bd": (rng.standard_normal((6,)) * 0.1).astype(np.float32),
           "shape": np.asarray([2, -1], np.int64)},
          ["x"], ["y"], x)


def test_dnsmos_standins_at_the_real_interfaces(rng, tmp_path):
    from chip_smoke import dnsmos_standins

    primary, p808 = dnsmos_standins(str(tmp_path))
    audio = (0.1 * rng.standard_normal((2, 144160))).astype(np.float32)
    mel = rng.uniform(-1.0, 1.0, (2, 900, 120)).astype(np.float32)
    for path, x, width in ((primary, audio, 3), (p808, mel, 1)):
        want = np.asarray(onnx_jax.OnnxModel(path)(x)[0])
        got = onnx_torch.OnnxModel(path, device="cpu")(x)[0].numpy()
        assert got.shape == want.shape == (2, width)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["ceil_mode", "pool_dilations", "avgpool_pads", "cast_code",
                                  "unknown_op", "secondary_output", "avgpool_ceil"])
def test_unsupported_semantics_raise_in_both(rng, tmp_path, case):
    x = rng.standard_normal((1, 1, 8, 8)).astype(np.float32)
    nodes = {
        "ceil_mode": [ow.node("MaxPool", ["x"], ["y"], kernel_shape=[2, 2], strides=[2, 2],
                              ceil_mode=1)],
        "pool_dilations": [ow.node("MaxPool", ["x"], ["y"], kernel_shape=[2, 2],
                                   dilations=[2, 2])],
        "avgpool_pads": [ow.node("AveragePool", ["x"], ["y"], kernel_shape=[2, 2],
                                 pads=[1, 1, 1, 1])],
        "avgpool_ceil": [ow.node("AveragePool", ["x"], ["y"], kernel_shape=[3, 3],
                                 strides=[2, 2], ceil_mode=1)],
        "cast_code": [ow.node("Cast", ["x"], ["y"], to=8)],  # string
        "unknown_op": [ow.node("Einsum", ["x"], ["y"])],
        "secondary_output": [ow.node("Dropout", ["x"], ["d", "mask"]),
                             ow.node("Add", ["d", "mask"], ["y"])],
    }[case]
    _raise_in_both(tmp_path, nodes, {}, ["x"], ["y"], x)


def test_cuda_device_raises_without_a_card(tmp_path, monkeypatch):
    path = ow.write_model(tmp_path / "m.onnx", [ow.node("Relu", ["x"], ["y"])], {}, ["x"],
                          ["y"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        onnx_torch.OnnxModel(path)

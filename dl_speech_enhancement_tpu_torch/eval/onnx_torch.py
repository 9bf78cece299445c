"""Execute a parsed ONNX graph with torch ops: enough ops for the DNSMOS
models.

Counterpart of dl_speech_enhancement_tpu/eval/onnx_jax.py. The graphs
(eval/onnx_graph.py::load_model) are topologically sorted; each node's
output is bound in an environment dict. Convs run through ``F.conv1d`` /
``F.conv2d`` (ONNX's NCHW / OIHW layouts are PyTorch's), pools through
``F.max_pool*d`` / ``F.avg_pool*d``, dense layers through ``torch.matmul``.
Float tensors live on the model's device; int64 initializers and constants
(shape and index operands) stay numpy on the host, as the JAX interpreter
keeps them, and an op that computes on them moves them to the device.

Padding: ``F.conv*d`` pads symmetrically and ``F.max_pool*d`` by at most
half the kernel, so explicit pads (``pads`` and ``auto_pad`` SAME_UPPER /
SAME_LOWER, whose odd pad goes at the end / the start) are applied first
with ``F.pad``, with zeros for a conv and ``-inf`` for a max pool. Where the
JAX interpreter raises NotImplementedError this one does too: ``ceil_mode``,
pool dilations, explicit average-pool pads, an unknown ``Cast`` code, an
unknown op, and a secondary output the graph consumes (only primary outputs
are computed).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dl_speech_enhancement_tpu_torch.eval.onnx_graph import Graph, load_model
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device


def _attr(node, name, default=None):
    a = node.attrs.get(name)
    return default if a is None else a.value


def _host(x) -> np.ndarray:
    """A shape or index operand on the host."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dev(x, device) -> torch.Tensor:
    """An operand as a tensor on ``device`` (host int64 operands moved)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x)).to(device)


def _opt_input(env, node, i):
    """Optional input i, or None: ONNX omits an optional input by cutting the
    input list short or with an empty name."""
    if len(node.inputs) > i and node.inputs[i]:
        return env[node.inputs[i]]
    return None


def _axes_of(env, node):
    """Reduce / Squeeze axes: the attribute (opset < 13 / 18), the input
    (later opsets), or None, all axes (the ONNX default)."""
    axes = _attr(node, "axes")
    if axes is None:
        inp = _opt_input(env, node, 1)
        if inp is not None:
            axes = _host(inp).tolist()
    if axes is None or axes == []:
        return None
    return tuple(int(a) for a in axes)


def _flat_pads(pairs) -> tuple:
    """[(lo, hi) per spatial dim, first to last] -> F.pad's order, last dim
    first."""
    return tuple(p for lo_hi in reversed(pairs) for p in lo_hi)


_CONVS = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOLS = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOLS = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _conv(env, node, device):
    x = _dev(env[node.inputs[0]], device)
    w = _dev(env[node.inputs[1]], device)
    b = _opt_input(env, node, 2)
    spatial = w.ndim - 2
    strides = tuple(int(s) for s in _attr(node, "strides", [1] * spatial))
    dilations = tuple(int(d) for d in _attr(node, "dilations", [1] * spatial))
    group = int(_attr(node, "group", 1))
    auto_pad = _attr(node, "auto_pad", b"NOTSET")
    if isinstance(auto_pad, bytes):
        auto_pad = auto_pad.decode()
    if auto_pad in ("VALID", "NOTSET"):
        pads = _attr(node, "pads", [0] * (2 * spatial))
        padding = [(int(pads[i]), int(pads[i + spatial])) for i in range(spatial)]
    elif auto_pad in ("SAME_UPPER", "SAME_LOWER"):
        padding = []
        for i in range(spatial):
            in_dim = x.shape[2 + i]
            eff_k = (w.shape[2 + i] - 1) * dilations[i] + 1
            out_dim = -(-in_dim // strides[i])
            total = max((out_dim - 1) * strides[i] + eff_k - in_dim, 0)
            small, big = total // 2, total - total // 2
            padding.append((small, big) if auto_pad == "SAME_UPPER" else (big, small))
    else:
        raise NotImplementedError(f"auto_pad {auto_pad}")
    if spatial not in _CONVS:
        raise NotImplementedError(f"{spatial}-D conv")
    if any(p for pair in padding for p in pair):
        x = F.pad(x, _flat_pads(padding))
    y = _CONVS[spatial](x, w, None, strides, 0, dilations, group)
    if b is not None:
        y = y + _dev(b, device).reshape((1, -1) + (1,) * spatial)
    return y


def _maxpool(env, node, device):
    x = _dev(env[node.inputs[0]], device)
    kernel = tuple(int(k) for k in _attr(node, "kernel_shape"))
    strides = tuple(int(s) for s in _attr(node, "strides", kernel))
    pads = _attr(node, "pads", [0] * (2 * len(kernel)))
    if int(_attr(node, "ceil_mode", 0)):
        raise NotImplementedError("MaxPool ceil_mode")
    if any(int(d) != 1 for d in _attr(node, "dilations", [1] * len(kernel))):
        raise NotImplementedError("MaxPool dilations")
    sp = len(kernel)
    if sp not in _MAX_POOLS:
        raise NotImplementedError(f"{sp}-D MaxPool")
    padding = [(int(pads[i]), int(pads[i + sp])) for i in range(sp)]
    if any(p for pair in padding for p in pair):
        x = F.pad(x, _flat_pads(padding), value=float("-inf"))
    return _MAX_POOLS[sp](x, kernel, strides)


def _avgpool(env, node, device):
    x = _dev(env[node.inputs[0]], device)
    kernel = tuple(int(k) for k in _attr(node, "kernel_shape"))
    strides = tuple(int(s) for s in _attr(node, "strides", kernel))
    if int(_attr(node, "ceil_mode", 0)):
        raise NotImplementedError("AveragePool ceil_mode")
    if any(int(p) != 0 for p in _attr(node, "pads", [0] * (2 * len(kernel)))):
        raise NotImplementedError("AveragePool explicit pads")
    if len(kernel) not in _AVG_POOLS:
        raise NotImplementedError(f"{len(kernel)}-D AveragePool")
    return _AVG_POOLS[len(kernel)](x, kernel, strides)


def _slice(env, node, device):
    x = _dev(env[node.inputs[0]], device)
    starts = _host(env[node.inputs[1]]).astype(np.int64)
    ends = _host(env[node.inputs[2]]).astype(np.int64)
    axes = (_host(env[node.inputs[3]]).astype(np.int64) if len(node.inputs) > 3
            else np.arange(len(starts)))
    steps = (_host(env[node.inputs[4]]).astype(np.int64) if len(node.inputs) > 4
             else np.ones(len(starts), np.int64))
    for s, e, a, st in zip(starts, ends, axes, steps):
        a = int(a) % x.ndim
        dim = x.shape[a]
        s, e, st = int(s), int(e), int(st)
        if st == 0:
            raise NotImplementedError("Slice step 0")
        # ONNX: a negative index wraps once, then clamps, the INT64_MIN /
        # INT64_MAX sentinels ("from the very start / end") included
        if s < 0:
            s += dim
        if e < 0:
            e += dim
        if st > 0:
            s, stop = min(max(s, 0), dim), min(max(e, 0), dim)
            x = x.narrow(a, s, max(stop - s, 0))[(slice(None),) * a + (slice(None, None, st),)]
        else:
            # torch slices take no negative step: gather the indices Python's
            # slice gives (e < 0 after wrapping means past the first element)
            s = min(max(s, 0), dim - 1)
            stop = None if e < 0 else min(e, dim - 1)
            idx = list(range(dim)[slice(s, stop, st)])
            x = x.index_select(a, torch.as_tensor(idx, dtype=torch.long, device=x.device))
    return x


_ELEMENTWISE = {
    "Relu": torch.relu,
    "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh,
    "Sqrt": torch.sqrt,
    "Log": torch.log,
    "Exp": torch.exp,
    "Abs": torch.abs,
    "Neg": torch.neg,
    "Identity": lambda x: x,
}

_BINARY = {
    "Add": torch.add,
    "Sub": torch.sub,
    "Mul": torch.mul,
    "Div": torch.true_divide,  # as jnp.divide: true division, ints included
    "Pow": torch.pow,
    "Max": torch.maximum,
    "Min": torch.minimum,
    "MatMul": torch.matmul,
}

# onnx.TensorProto dtype codes
_CAST = {1: torch.float32, 2: torch.uint8, 3: torch.int8, 5: torch.int16, 6: torch.int32,
         7: torch.int64, 9: torch.bool, 10: torch.float16, 11: torch.float64,
         16: torch.bfloat16}
for _code, _name in ((4, "uint16"), (12, "uint32"), (13, "uint64")):
    if hasattr(torch, _name):  # unsigned widths came in later PyTorch releases
        _CAST[_code] = getattr(torch, _name)


def _binary(op, a, b, device):
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return _BINARY[op](torch.as_tensor(a), torch.as_tensor(b)).to(device)
    return _BINARY[op](_dev(a, device), _dev(b, device))


def run_graph(graph: Graph, feeds: dict, consts: dict, device) -> list:
    """Execute ``graph`` on the input dict ``feeds`` (tensors on ``device``)
    with its uploaded initializers ``consts``; returns the output tensors."""
    env = dict(consts)
    env.update(feeds)

    # a secondary output (Dropout mask, Split parts, MaxPool indices) is not
    # computed: fail at the node that makes it if the graph consumes it
    consumed = set(graph.outputs)
    for node in graph.nodes:
        consumed.update(node.inputs)

    for node in graph.nodes:
        op = node.op_type
        inp = [env[i] if i else None for i in node.inputs]
        if op in _ELEMENTWISE:
            out = _ELEMENTWISE[op](_dev(inp[0], device))
        elif op in _BINARY:
            out = _binary(op, inp[0], inp[1], device)
        elif op == "Conv":
            out = _conv(env, node, device)
        elif op == "MaxPool":
            out = _maxpool(env, node, device)
        elif op == "AveragePool":
            out = _avgpool(env, node, device)
        elif op == "GlobalAveragePool":
            x = _dev(inp[0], device)
            out = torch.mean(x, dim=tuple(range(2, x.ndim)), keepdim=True)
        elif op == "Transpose":
            x = _dev(inp[0], device)
            perm = _attr(node, "perm")
            out = x.permute(*(reversed(range(x.ndim)) if perm is None else perm))
        elif op == "Reshape":
            shape = _host(inp[1]).astype(np.int64).tolist()
            out = _dev(inp[0], device).reshape(shape)
        elif op == "Flatten":
            x = _dev(inp[0], device)
            axis = int(_attr(node, "axis", 1))
            out = x.reshape(int(np.prod(x.shape[:axis])), -1)
        elif op == "Concat":
            out = torch.cat([_dev(t, device) for t in inp], dim=int(_attr(node, "axis")))
        elif op == "Unsqueeze":
            axes = _attr(node, "axes")
            if axes is None:
                axes = _host(inp[1]).tolist()
            out = _dev(inp[0], device)
            for a in sorted(int(a) for a in axes):
                out = out.unsqueeze(a)
        elif op == "Squeeze":
            x, axes = _dev(inp[0], device), _axes_of(env, node)
            out = x.squeeze() if axes is None else x.squeeze(axes)
        elif op == "Slice":
            out = _slice(env, node, device)
        elif op in ("ReduceMax", "ReduceMean"):
            x = _dev(inp[0], device)
            axes = _axes_of(env, node) or tuple(range(x.ndim))
            keep = bool(_attr(node, "keepdims", 1))
            out = (torch.amax(x, dim=axes, keepdim=keep) if op == "ReduceMax"
                   else torch.mean(x, dim=axes, keepdim=keep))
        elif op == "Gemm":
            a, b = _dev(inp[0], device), _dev(inp[1], device)
            if _attr(node, "transA", 0):
                a = a.T
            if _attr(node, "transB", 0):
                b = b.T
            out = _attr(node, "alpha", 1.0) * (a @ b)
            if len(inp) > 2:
                out = out + _attr(node, "beta", 1.0) * _dev(inp[2], device)
        elif op == "Softmax":
            out = torch.softmax(_dev(inp[0], device), dim=int(_attr(node, "axis", -1)))
        elif op == "Clip":
            out = _dev(inp[0], device)
            lo, hi = _opt_input(env, node, 1), _opt_input(env, node, 2)
            if lo is not None:
                out = torch.maximum(out, _dev(lo, device).to(out.dtype))
            if hi is not None:
                out = torch.minimum(out, _dev(hi, device).to(out.dtype))
        elif op == "Dropout":
            out = inp[0]
        elif op == "Cast":
            to = int(_attr(node, "to"))
            if to not in _CAST:
                raise NotImplementedError(f"Cast to dtype code {to}")
            out = _dev(inp[0], device).to(_CAST[to])
        elif op == "Constant":
            value = node.attrs["value"]
            data = np.asarray(value.t.data if value.t is not None else value.value)
            out = data if data.dtype == np.int64 else _dev(data, device)
        else:
            raise NotImplementedError(f"ONNX op: {op}")
        for extra in node.outputs[1:]:
            if extra and extra in consumed:
                raise NotImplementedError(
                    f"{op} secondary output '{extra}' is consumed by the graph: only "
                    "primary outputs are computed")
        env[node.outputs[0]] = out
    return [_dev(env[o], device) for o in graph.outputs]


class OnnxModel:
    """An ONNX model on ``device`` (the card by default; raises without one):
    ``model(*inputs) -> [outputs]``, tensors on the device. The initializers
    are uploaded once, int64 ones kept on the host."""

    def __init__(self, path: str, device="cuda"):
        self.device = resolve_device(device)
        self.graph = load_model(path)
        self.input_names = [n for n in self.graph.inputs if n not in self.graph.initializers]
        self.consts = {name: data if data.dtype == np.int64 else _dev(data, self.device)
                       for name, data in self.graph.initializers.items()}

    @torch.no_grad()
    def __call__(self, *args) -> list:
        feeds = {name: (a.to(self.device) if isinstance(a, torch.Tensor)
                        else _dev(np.asarray(a), self.device))
                 for name, a in zip(self.input_names, args)}
        return run_graph(self.graph, feeds, self.consts, self.device)

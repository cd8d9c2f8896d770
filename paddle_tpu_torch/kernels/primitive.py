"""Kernel primitives: a user's elementwise or row-reduction function lifted
into a Triton kernel for Hopper (``paddle_tpu/kernels/primitive.py``
analog).

Replaces ``elementwise_kernel`` (``primitive.py:62``, whose inner
``kernel`` is launched at ``:87``) and ``row_reduce_kernel`` (``:100``,
launched at ``:146``): factories that turn a plain function into a tiled
kernel with fp32 math, the output in the first operand's dtype.

    scaled_residual = elementwise_kernel(lambda x, y, a: x + a * torch.tanh(y))
    out = scaled_residual(x, y, alpha)          # same-shape operands
    row_sum = row_reduce_kernel(lambda acc, b: acc + b.sum(-1), 0.0)
    s = row_sum(x)                              # [..., C] -> [...]

Each factory must compile a *Python function* at run time, which is what
Triton's JIT does on this card. The factory traces ``fn`` with
``torch.fx.symbolic_trace`` and writes the ``@triton.jit`` kernel from a
small table (``+ - * / neg pow``, the comparisons, ``tanh exp log sqrt
rsqrt sigmoid abs maximum minimum where``, Python numbers, and for
reductions ``sum amax amin`` over the last axis). An operation outside the
table raises ``ValueError`` naming it when the factory is called. The
source is kept on the returned callable (``.source``); at its first launch
it is written into the package's git-ignored build directory, which
``triton.jit`` needs, and imported once per distinct source.

What bounds both on the H100: bytes (a few operations per element). The
elementwise kernel reads each operand once and writes the output once,
flat, ``block_rows`` elements per program with the tail masked: the
operands are read flat, so a "row" of the reference's ``[rows, 128]``
view is one element here, and no operand is padded or copied. The
reduction takes a ``[BR, BC]`` tile of rows per program and walks the
column blocks in order, keeping the fp32 accumulator in registers, as the
reference walks its sequential grid axis. ``BC`` is the largest power of
two not above ``block_cols`` that divides the row length ``C``: for
aligned rows (``C`` a power of two or a multiple of ``block_cols``) that
is the reference's ``divisor_block``, so blocks are reduced in its order;
any other ``C`` runs on the kernel too, with smaller blocks, and odd ``C``
(``BC`` = 1) is slow. The reference's jnp route for unaligned shapes is not
copied: a lane past a ragged edge could not be fed an identity element for
an arbitrary ``fn``, so rows are masked and columns never are.

Mosaic's layout helpers (``LANES``, ``SUBLANES``, ``to_tiled_2d``,
``pad_rows``, ``row_block_spec``) are not ported: they encode the TPU's
``(8, 128)`` tiling, which nothing on this card needs.
"""

from __future__ import annotations

import hashlib
import importlib.util
import inspect
import math
import operator
import os
import sys

import torch
import torch.fx

from . import _build

#: elements each program of an elementwise kernel handles
DEFAULT_BLOCK_ROWS = 2048
#: elements in one [BR, BC] tile of a reduction
_TILE = 4096
_KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

# fx target -> table name
_FUNCS = {
    operator.add: "add", operator.sub: "sub", operator.mul: "mul",
    operator.truediv: "truediv", operator.neg: "neg", operator.pow: "pow",
    operator.gt: "gt", operator.ge: "ge", operator.lt: "lt", operator.le: "le",
    operator.eq: "eq", operator.ne: "ne", operator.abs: "abs",
    torch.tanh: "tanh", torch.exp: "exp", torch.log: "log",
    torch.sqrt: "sqrt", torch.rsqrt: "rsqrt", torch.sigmoid: "sigmoid",
    torch.abs: "abs", torch.maximum: "maximum", torch.minimum: "minimum",
    torch.where: "where", torch.sum: "sum", torch.amax: "amax",
    torch.amin: "amin",
}
_METHODS = {m: m for m in ("tanh", "exp", "log", "sqrt", "rsqrt", "sigmoid",
                           "abs", "neg", "maximum", "minimum", "sum", "amax",
                           "amin")}
# table name -> Triton expression. Infix operators take a Python number
# as it is; a call gets it as a tensor shaped like its tensor operand.
_INFIX = {"add": "+", "sub": "-", "mul": "*", "gt": ">", "ge": ">=",
          "lt": "<", "le": "<=", "eq": "==", "ne": "!="}
_CALLS = {
    "truediv": "tl.div_rn({0}, {1})",
    "pow": "libdevice.pow({0}, {1})",
    "neg": "(-{0})",
    "abs": "tl.abs({0})",
    "tanh": "libdevice.tanh({0})",
    "exp": "libdevice.exp({0})",
    "log": "libdevice.log({0})",
    "sqrt": "tl.sqrt_rn({0})",
    "rsqrt": "libdevice.rsqrt({0})",
    "sigmoid": "tl.div_rn(tl.zeros_like({0}) + 1.0, "
               "1.0 + libdevice.exp(-{0}))",
    "maximum": "tl.maximum({0}, {1}, propagate_nan=tl.PropagateNan.ALL)",
    "minimum": "tl.minimum({0}, {1}, propagate_nan=tl.PropagateNan.ALL)",
    "where": "tl.where({0}, {1}, {2})",
}
_REDUCE = {"sum": "tl.sum({0}, axis=1)", "amax": "tl.max({0}, axis=1)",
           "amin": "tl.min({0}, axis=1)"}

_HEADER = """\
import triton
import triton.language as tl
try:
    from triton.language.extra import libdevice
except ImportError:
    from triton.language.extra.cuda import libdevice


"""
_modules = {}


def _describe(node):
    t = node.target
    return t if isinstance(t, str) else getattr(t, "__name__", repr(t))


def _translate(fn, kinds):
    """Trace ``fn`` and translate its graph into Triton statements.

    ``kinds`` names each parameter's value kind (``vec``; or ``row`` and
    ``block`` for a reduction). Returns ``(lines, result)``: statements
    assigning ``t0, t1, ...`` and the ``(expression, kind)`` of the result.
    Raises ``ValueError`` for anything outside the table."""
    try:
        graph = torch.fx.symbolic_trace(fn).graph
    except Exception as e:  # fx raises many types for untraceable code
        raise ValueError(f"cannot trace {fn!r} with torch.fx: {e}") from e
    env, lines, n_params, result = {}, [], 0, None

    def operand(a):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, (bool, int, float)) and math.isfinite(a):
            return (repr(float(a)), "const")
        raise ValueError(f"unsupported operand {a!r} in {fn!r}: only the "
                         "function's arguments and finite Python numbers")

    for node in graph.nodes:
        if node.op == "placeholder":
            if n_params >= len(kinds):
                raise ValueError(f"{fn!r} takes more arguments than the "
                                 f"{len(kinds)} this factory passes")
            env[node] = (f"v{n_params}", kinds[n_params])
            n_params += 1
            continue
        if node.op == "output":
            result = operand(node.args[0])
            continue
        if node.op == "call_function":
            name = _FUNCS.get(node.target)
        elif node.op == "call_method":
            name = _METHODS.get(node.target)
        else:  # get_attr: a tensor closed over; call_module
            raise ValueError(f"unsupported {node.op} {_describe(node)!r} in "
                             f"{fn!r}: pass tensors as operands")
        if name is None:
            raise ValueError(f"unsupported operation {_describe(node)!r} in "
                             f"{fn!r}; supported: "
                             f"{sorted(set(_FUNCS.values()))}")
        if name in _REDUCE:
            expr, kind = _reduction(fn, name, node, operand)
        else:
            if node.kwargs:
                raise ValueError(f"{name} in {fn!r}: keyword arguments "
                                 f"{sorted(node.kwargs)} are not supported")
            args = [operand(a) for a in node.args]
            tensors = [k for _, k in args if k != "const"]
            if not tensors:
                raise ValueError(f"{name} in {fn!r} has no tensor operand")
            if len(set(tensors)) > 1:
                raise ValueError(f"{name} in {fn!r} mixes a [rows] value and "
                                 "a [rows, cols] block")
            kind = tensors[0]
            if name in _INFIX:
                expr = f"({args[0][0]} {_INFIX[name]} {args[1][0]})"
            else:
                like = next(e for e, k in args if k != "const")
                exprs = [f"(tl.zeros_like({like}) + {e})" if k == "const"
                         else e for e, k in args]
                expr = _CALLS[name].format(*exprs)
        env[node] = (f"t{len(lines)}", kind)
        lines.append(f"t{len(lines)} = {expr}")
    if n_params != len(kinds):
        raise ValueError(f"{fn!r} takes {n_params} arguments; this factory "
                         f"passes {len(kinds)}")
    return lines, result


def _reduction(fn, name, node, operand):
    args, kw = list(node.args), dict(node.kwargs)
    dims = kw.pop("dim", kw.pop("axis", args[1] if len(args) > 1 else None))
    keepdim = kw.pop("keepdim", args[2] if len(args) > 2 else False)
    if kw or len(args) > 3:
        raise ValueError(f"{name} in {fn!r}: unsupported arguments {kw}")
    dims = dims if isinstance(dims, (tuple, list)) else (dims,)
    src, kind = operand(args[0])
    if kind != "block" or keepdim or len(dims) != 1 or dims[0] not in (-1, 1):
        raise ValueError(f"{name} in {fn!r}: only a reduction of the "
                         "[rows, cols] block over its last axis, without "
                         "keepdim, is supported")
    return _REDUCE[name].format(src), "row"


def _load(source: str, name: str):
    """The kernel ``name`` defined by ``source``: the text is written into
    the build directory under its hash and imported once."""
    digest = hashlib.sha1(source.encode()).hexdigest()[:16]
    mod = _modules.get(digest)
    if mod is None:
        _build.triton()
        d = _build.BUILD / "primitive"
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"kernel_{digest}.py"
        if not path.exists():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(source)
            os.replace(tmp, path)
        modname = f"paddle_tpu_torch_primitive_{digest}"
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        spec.loader.exec_module(mod)
        _modules[digest] = mod
    return getattr(mod, name)


def _result_expr(result, like):
    expr, kind = result
    return f"(tl.zeros_like({like}) + {expr})" if kind == "const" else expr


def _on_card(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: unsupported dtype {t.dtype}")


# ---------------- elementwise ----------------------------------------------
def elementwise_ref(fn, *operands):
    """Plain PyTorch version: ``fn`` on the operands in fp32, the result in
    the first operand's dtype."""
    out = fn(*(a.float() for a in operands))
    shape, dev = operands[0].shape, operands[0].device
    out = torch.as_tensor(out, dtype=torch.float32, device=dev)
    return torch.broadcast_to(out, shape).to(operands[0].dtype)


def _elementwise_source(lines, result, n):
    ins = ", ".join(f"x{i}" for i in range(n))
    body = [f"v{i} = tl.load(x{i} + offs, mask=mask, other=0.0)"
            ".to(tl.float32)" for i in range(n)] + lines
    body.append(f"tl.store(out + offs, {_result_expr(result, 'v0')}"
                ".to(out.dtype.element_ty), mask=mask)")
    return (_HEADER + "@triton.jit\n"
            f"def primitive_elementwise({ins}, out, n, BLOCK: tl.constexpr):\n"
            "    offs = tl.program_id(0).to(tl.int64) * BLOCK"
            " + tl.arange(0, BLOCK)\n"
            "    mask = offs < n\n"
            + "".join(f"    {s}\n" for s in body))


def elementwise_kernel(fn, block_rows: int = DEFAULT_BLOCK_ROWS):
    """Lift ``fn(*operands) -> value`` (fp32 math) into a Triton kernel over
    any number of same-shaped operands; returns ``call(*operands)``, whose
    output takes the first operand's dtype. CPU tensors run
    ``elementwise_ref``; CUDA tensors launch the kernel or raise. Raises
    ``ValueError`` here for an operation the kernel cannot express."""
    n = len(inspect.signature(fn).parameters)
    lines, result = _translate(fn, ["vec"] * n)
    if block_rows < 1 or block_rows & (block_rows - 1):
        raise ValueError(f"block_rows must be a power of two, got {block_rows}")
    source = _elementwise_source(lines, result, n)

    def call(*operands):
        if len(operands) != n:
            raise TypeError(f"{fn!r} takes {n} operands, got {len(operands)}")
        ops = [torch.as_tensor(a) for a in operands]
        shape, dev = ops[0].shape, ops[0].device
        for a in ops[1:]:
            if a.shape != shape:
                raise ValueError(f"elementwise operands must share a shape; "
                                 f"got {tuple(shape)} vs {tuple(a.shape)}")
            if a.device != dev:
                raise ValueError(f"elementwise operands must share a device; "
                                 f"got {dev} and {a.device}")
        if dev.type == "cpu":
            return elementwise_ref(fn, *ops)
        for a in ops:
            _on_card("elementwise_kernel", a)
        kernel = _load(source, "primitive_elementwise")
        out = torch.empty(shape, dtype=ops[0].dtype, device=dev)
        numel = out.numel()
        if numel:
            kernel[(-(-numel // block_rows),)](
                *(a.contiguous().view(-1) for a in ops), out.view(-1), numel,
                BLOCK=block_rows, num_warps=8 if block_rows > 1024 else 4)
            elementwise_kernel.launches += 1
        return out

    call.source = source
    call.__name__ = getattr(fn, "__name__", "elementwise")
    call.__doc__ = fn.__doc__
    return call


elementwise_kernel.launches = 0


# ---------------- row reduction --------------------------------------------
def _col_block(limit: int, cols: int) -> int:
    """The largest power of two not above ``limit`` that divides ``cols``."""
    b = 1
    while b * 2 <= limit and cols % (b * 2) == 0:
        b *= 2
    return b


def row_reduce_ref(fn, init: float, x, block_cols: int = 1024):
    """Plain PyTorch version: ``acc = fn(acc, block)`` over the column
    blocks of ``x`` viewed as ``[rows, C]``, in order, the fp32 accumulator
    starting at ``init``; the result in x's dtype, shape ``x.shape[:-1]``."""
    *lead, C = x.shape
    x2 = x.reshape(-1, C).float()
    bc = _col_block(block_cols, C)
    acc = torch.full((x2.shape[0],), float(init), dtype=torch.float32,
                     device=x.device)
    for c0 in range(0, C, bc):
        acc = torch.as_tensor(fn(acc, x2[:, c0:c0 + bc]),
                              dtype=torch.float32, device=x.device)
    return torch.broadcast_to(acc, x2.shape[:1]).reshape(lead).to(x.dtype)


def _row_reduce_source(lines, result):
    body = ["blk = tl.load(x + rows[:, None] * C + (c0 + cols)[None, :], "
            "mask=rmask[:, None], other=0.0).to(tl.float32)",
            "v0 = acc", "v1 = blk"] + lines
    body.append(f"acc = {_result_expr(result, 'acc')}.to(tl.float32)")
    return (_HEADER + "@triton.jit\n"
            "def primitive_row_reduce(x, out, R, C, init, BR: tl.constexpr, "
            "BC: tl.constexpr):\n"
            "    rows = tl.program_id(0).to(tl.int64) * BR + tl.arange(0, BR)\n"
            "    rmask = rows < R\n"
            "    cols = tl.arange(0, BC)\n"
            "    acc = tl.zeros([BR], tl.float32) + init\n"
            "    for c0 in range(0, C, BC):\n"
            + "".join(f"        {s}\n" for s in body)
            + "    tl.store(out + rows, acc.to(out.dtype.element_ty), "
              "mask=rmask)\n")


def row_reduce_kernel(fn, init: float, block_cols: int = 1024):
    """Lift a pairwise reduction ``fn(acc, block) -> acc`` over the LAST
    axis into a Triton kernel; returns ``call(x)``: ``[..., C] -> [...]``
    in x's dtype, the fp32 accumulator starting at ``init``. CPU tensors
    run ``row_reduce_ref``; CUDA tensors launch the kernel or raise. Raises
    ``ValueError`` here for an operation the kernel cannot express."""
    lines, result = _translate(fn, ["row", "block"])
    if result[1] == "block":
        raise ValueError(f"{fn!r} returns a [rows, cols] block; a reduction "
                         "returns one value per row")
    if block_cols < 1:
        raise ValueError(f"block_cols must be positive, got {block_cols}")
    source = _row_reduce_source(lines, result)

    def call(x):
        x = torch.as_tensor(x)
        if x.dim() == 0:
            raise ValueError("row_reduce_kernel needs at least one axis")
        if x.device.type == "cpu":
            return row_reduce_ref(fn, init, x, block_cols)
        _on_card("row_reduce_kernel", x)
        *lead, C = x.shape
        R = math.prod(lead)
        out = torch.empty(lead, dtype=x.dtype, device=x.device)
        if R:
            kernel = _load(source, "primitive_row_reduce")
            bc = _col_block(block_cols, C)
            br = max(1, min(1 << (R - 1).bit_length(), _TILE // bc))
            kernel[(-(-R // br),)](x.contiguous().view(R, C), out.view(R), R,
                                   C, float(init), BR=br, BC=bc, num_warps=4)
            row_reduce_kernel.launches += 1
        return out

    call.source = source
    call.__name__ = getattr(fn, "__name__", "row_reduce")
    return call


row_reduce_kernel.launches = 0

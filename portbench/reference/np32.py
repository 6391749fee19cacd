"""NumPy with the array semantics the reference's modules are written in:
32-bit types (no 64-bit integer or float ever comes out), JAX's type
promotion (an int32 and a float32 give a float32, a Python scalar takes
the array's kind), functional updates (``x.at[i].set(v)``, ``.add``) and plain Python loops for ``lax``'s.

The reference's modules import this as ``jnp`` (and as ``jax`` for the
loops), so that they read as the simulator's semantics are written, and
run on NumPy alone: nothing here is JAX or the program.
"""

from __future__ import annotations

import builtins

import numpy as np

int32, uint32, float32 = np.int32, np.uint32, np.float32

_CANON = {np.dtype(np.int64): np.dtype(np.int32), np.dtype(np.uint64): np.dtype(np.uint32),
          np.dtype(np.float64): np.dtype(np.float32), np.dtype(np.float16): np.dtype(np.float32)}


def canon(dt) -> np.dtype:
    """The 32-bit dtype a requested dtype stands for."""
    if dt is bool:
        return np.dtype(np.bool_)
    if dt is int:
        return np.dtype(np.int32)
    if dt is float:
        return np.dtype(np.float32)
    d = np.dtype(dt)
    return _CANON.get(d, d)


class Array(np.ndarray):
    """An ndarray that keeps to 32-bit types and has JAX's ``.at``."""

    def __array_finalize__(self, obj):
        pass

    @property
    def at(self):
        return _At(self)

    def __getitem__(self, idx):
        return _wrap(np.ndarray.__getitem__(self.view(np.ndarray), _unwrap_index(idx)))

    def __setitem__(self, idx, v):
        raise TypeError("arrays are immutable here: use x.at[idx].set(v)")

    def __array_ufunc__(self, ufunc, method, *inputs, out=None, **kw):
        if out is not None:
            raise TypeError("no out= here")
        args = [_unwrap(x) for x in inputs]
        if method == "__call__":
            args = _promote_args(ufunc, args)
            return _wrap(ufunc(*args, **kw))
        if method in ("reduce", "accumulate"):
            a = args[0]
            if "dtype" not in kw or kw["dtype"] is None:
                if ufunc in (np.add, np.multiply) and a.dtype.kind in "biu":
                    kw["dtype"] = np.uint32 if a.dtype.kind == "u" else np.int32
            else:
                kw["dtype"] = canon(kw["dtype"])
            return _wrap(getattr(ufunc, method)(a, *args[1:], **kw))
        return _wrap(getattr(ufunc, method)(*args, **kw))

    # ``a op= b`` rebinds ``a`` to a new array, as JAX's immutable arrays do
    __iadd__ = lambda self, o: self + o              # noqa: E731
    __isub__ = lambda self, o: self - o              # noqa: E731
    __imul__ = lambda self, o: self * o              # noqa: E731
    __itruediv__ = lambda self, o: self / o          # noqa: E731
    __ifloordiv__ = lambda self, o: self // o        # noqa: E731
    __imod__ = lambda self, o: self % o              # noqa: E731
    __iand__ = lambda self, o: self & o              # noqa: E731
    __ior__ = lambda self, o: self | o               # noqa: E731
    __ixor__ = lambda self, o: self ^ o              # noqa: E731
    __ilshift__ = lambda self, o: self << o          # noqa: E731
    __irshift__ = lambda self, o: self >> o          # noqa: E731

    def astype(self, dtype, **kw):
        return _wrap(self.view(np.ndarray).astype(canon(dtype)))

    def sum(self, axis=None, dtype=None, keepdims=False, **kw):
        return sum(self, axis=axis, dtype=dtype, keepdims=keepdims)

    def mean(self, axis=None, dtype=None, keepdims=False, **kw):
        return mean(self, axis=axis, keepdims=keepdims)

    def cumsum(self, axis=None, dtype=None, **kw):
        return cumsum(self, axis=axis, dtype=dtype)

    def clip(self, lo=None, hi=None, **kw):
        return clip(self, lo, hi)

    def copy(self, order="C"):
        return _wrap(np.array(self.view(np.ndarray), copy=True))


ndarray = Array


def _unwrap(x):
    if isinstance(x, Array):
        return x.view(np.ndarray)
    return x


def _unwrap_index(idx):
    if isinstance(idx, tuple):
        return tuple(_unwrap(i) for i in idx)
    return _unwrap(idx)


def _wrap(r):
    if isinstance(r, tuple):
        return tuple(_wrap(x) for x in r)
    if isinstance(r, (np.ndarray, np.generic)):
        a = np.asarray(r)
        d = canon(a.dtype)
        if d != a.dtype:
            a = a.astype(d)
        return a.view(Array)
    return r


def _is_weak(x) -> bool:
    return isinstance(x, (bool, int, float)) and not isinstance(x, np.generic)


def promote_types(a: np.dtype, b: np.dtype) -> np.dtype:
    """JAX's promotion of two canonical dtypes, canonicalised."""
    a, b = np.dtype(a), np.dtype(b)
    if a == b:
        return a
    if a.kind == "b":
        return b
    if b.kind == "b":
        return a
    if a.kind == "f" or b.kind == "f":
        fs = [d for d in (a, b) if d.kind == "f"]
        return canon(builtins.max(fs, key=lambda d: d.itemsize))
    if a.kind == b.kind:          # both signed or both unsigned
        return a if a.itemsize >= b.itemsize else b
    s, u = (a, b) if a.kind == "i" else (b, a)
    if u.itemsize < s.itemsize:
        return s
    return np.dtype(np.int32)     # int64 in JAX, int32 with 64-bit types off


def result_dtype(args) -> np.dtype | None:
    strong = [canon(np.asarray(x).dtype) for x in args if not _is_weak(x) and x is not None]
    weak = [x for x in args if _is_weak(x)]
    if strong:
        d = strong[0]
        for s in strong[1:]:
            d = promote_types(d, s)
    else:
        if builtins.any(isinstance(w, float) for w in weak):
            return np.dtype(np.float32)
        if builtins.any(isinstance(w, int) and not isinstance(w, bool) for w in weak):
            return np.dtype(np.int32)
        return np.dtype(np.bool_) if weak else None
    if d.kind in "biu" and builtins.any(isinstance(w, float) for w in weak):
        return np.dtype(np.float32)
    if d.kind == "b" and builtins.any(isinstance(w, int) and not isinstance(w, bool) for w in weak):
        return np.dtype(np.int32)
    return d


_FLOAT_OUT = {np.true_divide, np.floor, np.ceil, np.exp, np.log, np.sqrt, np.log2, np.exp2,
              np.power, np.float_power, np.rint, np.trunc, np.log1p, np.expm1}
_SAME = {np.add, np.subtract, np.multiply, np.floor_divide, np.remainder, np.minimum,
         np.maximum, np.bitwise_and, np.bitwise_or, np.bitwise_xor, np.left_shift,
         np.right_shift, np.equal, np.not_equal, np.less, np.less_equal, np.greater,
         np.greater_equal, np.fmin, np.fmax, np.logical_and, np.logical_or, np.logical_xor,
         np.copysign, np.arctan2, np.hypot, np.fmod}


def _promote_args(ufunc, args):
    d = result_dtype(args)
    if d is None:
        return args
    if ufunc in _FLOAT_OUT and d.kind in "biu":
        d = np.dtype(np.float32)
    if ufunc in _FLOAT_OUT or ufunc in _SAME or ufunc.nin == 1:
        out = []
        for x in args:
            if _is_weak(x):
                out.append(np.asarray(x, d) if d.kind == "f" or isinstance(x, bool)
                           or d.kind == "b" else x)
            else:
                x = np.asarray(x)
                out.append(x if x.dtype == d else x.astype(d))
        return out
    return args


def _cast(v, dtype):
    v = _unwrap(v)
    return np.asarray(v).astype(dtype) if not _is_weak(v) else np.asarray(v, dtype)


class _At:
    def __init__(self, arr):
        self.arr = arr

    def __getitem__(self, idx):
        return _Ref(self.arr, _unwrap_index(idx))


class _Ref:
    def __init__(self, arr, idx):
        self.arr, self.idx = arr, idx

    def _base(self):
        return np.array(self.arr.view(np.ndarray), copy=True)

    def set(self, v, **kw):
        out = self._base()
        out[self.idx] = _cast(v, out.dtype)
        return _wrap(out)

    def _at(self, uf, v):
        out = self._base()
        uf.at(out, self.idx, _cast(v, out.dtype))
        return _wrap(out)

    def add(self, v, **kw):
        return self._at(np.add, v)



# ------------------------------------------------------------------ creation


def asarray(x, dtype=None):
    if dtype is not None:
        return _wrap(np.asarray(_unwrap(x)).astype(canon(dtype)))
    if _is_weak(x):
        return _wrap(np.asarray(x, result_dtype([x])))
    if isinstance(x, (list, tuple)):
        items = [_unwrap(v) for v in x]
        d = result_dtype([v for v in _flat(items)]) or np.dtype(np.float32)
        return _wrap(np.asarray(items).astype(d))
    return _wrap(np.asarray(_unwrap(x)))


def _flat(items):
    for v in items:
        if isinstance(v, (list, tuple)):
            yield from _flat(v)
        else:
            yield v


def copy(x):
    return _wrap(np.array(_unwrap(x), copy=True))


def zeros(shape, dtype=float32):
    return _wrap(np.zeros(shape, canon(dtype)))


def ones(shape, dtype=float32):
    return _wrap(np.ones(shape, canon(dtype)))


def full(shape, fill, dtype=None):
    d = canon(dtype) if dtype is not None else result_dtype([fill])
    return _wrap(np.full(shape, _unwrap(fill), d))


def zeros_like(x, dtype=None):
    return _wrap(np.zeros(np.shape(x), canon(dtype) if dtype else canon(np.asarray(x).dtype)))


def arange(*a, dtype=None):
    r = np.arange(*[_unwrap(v) for v in a])
    return _wrap(r.astype(canon(dtype)) if dtype is not None else r)


# ------------------------------------------------------------ element-wise


def where(c, a=None, b=None):
    if a is None and b is None:
        return _wrap(np.nonzero(_unwrap(c)))
    d = result_dtype([a, b])
    return _wrap(np.where(_unwrap(c), _cast(a, d), _cast(b, d)))


def _arr(x):
    return x if isinstance(x, Array) else asarray(x)


def _opnd(x):
    return x if _is_weak(x) else _arr(x)


def maximum(a, b):
    if _is_weak(a) and _is_weak(b):
        return asarray(builtins.max(a, b))
    return np.maximum(_opnd(a), _opnd(b))


def minimum(a, b):
    if _is_weak(a) and _is_weak(b):
        return asarray(builtins.min(a, b))
    return np.minimum(_opnd(a), _opnd(b))


def clip(x, lo=None, hi=None):
    x = _arr(x)
    if lo is not None:
        x = np.maximum(x, _opnd(lo))
    if hi is not None:
        x = np.minimum(x, _opnd(hi))
    return x


def floor(x):
    return np.floor(_arr(x))


def ldexp(x, e):
    x = _arr(x)
    return _wrap(np.ldexp(_unwrap(x), np.asarray(_unwrap(e)).astype(np.int32)))


# ----------------------------------------------------------------- reductions


def _acc(x, dtype):
    if dtype is not None:
        return canon(dtype)
    k = x.dtype.kind
    return np.dtype(np.int32) if k in "bi" else (np.dtype(np.uint32) if k == "u" else x.dtype)


def sum(x, axis=None, dtype=None, keepdims=False):
    a = np.asarray(_unwrap(x))
    return _wrap(np.sum(a, axis=axis, dtype=_acc(a, dtype), keepdims=keepdims))


def cumsum(x, axis=None, dtype=None):
    a = np.asarray(_unwrap(x))
    return _wrap(np.cumsum(a, axis=axis, dtype=_acc(a, dtype)))


def mean(x, axis=None, keepdims=False):
    a = np.asarray(_unwrap(x))
    if a.dtype.kind != "f":
        a = a.astype(np.float32)
    return _wrap(np.mean(a, axis=axis, dtype=np.float32, keepdims=keepdims))


def _red(fn):
    def f(x, axis=None, keepdims=False, **kw):
        return _wrap(fn(np.asarray(_unwrap(x)), axis=axis, keepdims=keepdims))
    return f


max = _red(np.max)      # noqa: A001 - the jnp names
min = _red(np.min)      # noqa: A001
any = _red(np.any)      # noqa: A001
all = _red(np.all)      # noqa: A001


def argmax(x, axis=None):
    return _wrap(np.argmax(np.asarray(_unwrap(x)), axis=axis).astype(np.int32))


def argmin(x, axis=None):
    return _wrap(np.argmin(np.asarray(_unwrap(x)), axis=axis).astype(np.int32))


# ------------------------------------------------------------------- shapes


def _uw_list(xs):
    return [np.asarray(_unwrap(x)) for x in xs]


def stack(xs, axis=0):
    xs = _uw_list(xs)
    d = result_dtype(xs)
    return _wrap(np.stack([x.astype(d) for x in xs], axis=axis))


def concatenate(xs, axis=0):
    xs = _uw_list(xs)
    d = result_dtype(xs)
    return _wrap(np.concatenate([x.astype(d) for x in xs], axis=axis))


def pad(x, width, mode="constant", constant_values=0):
    return _wrap(np.pad(np.asarray(_unwrap(x)), width, mode=mode,
                        constant_values=_unwrap(constant_values)))


def broadcast_to(x, shape):
    return _wrap(np.array(np.broadcast_to(np.asarray(_unwrap(x)), shape)))


def take_along_axis(x, idx, axis):
    return _wrap(np.take_along_axis(np.asarray(_unwrap(x)), np.asarray(_unwrap(idx)), axis))


# ------------------------------------------------- jax / lax, run in Python


class _Lax:
    @staticmethod
    def while_loop(cond, body, x):
        while bool(cond(x)):
            x = body(x)
        return x

    @staticmethod
    def fori_loop(lo, hi, body, x):
        for i in range(int(lo), int(hi)):
            x = body(i, x)
        return x

    @staticmethod
    def cond(p, t, f, *ops):
        return t(*ops) if bool(p) else f(*ops)


lax = _Lax()


def jit(fn=None, **kw):
    if fn is None:
        return lambda f: f
    return fn

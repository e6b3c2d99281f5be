"""The tuner's kernel families (``paddle_tpu/pallas/tuning/space.py``).

A family describes one tunable kernel:

- ``shape_names``    -- what the dims of a tune shape mean (the key's
  shape, as the wrapper looks it up);
- ``default_shapes`` -- what ``paddle tune`` measures when given none: shapes
  that the port's paths launch at full width (the registry names the path
  of each), so that an entry tuned there is looked up on that path;
- ``smoke_shapes``   -- tiny shapes for ``--smoke``;
- ``configs(shape, dtype, sms)`` -- every candidate at the shape other
  than the wrapper's own choice, each valid by the wrapper's own
  predicate (the one dispatch re-checks a hit with) and the caps that bind
  numerics (the bf16 filter gradient's _WG_MAX_STEPS K steps a split); a
  candidate never changes an operand's layout, so the split-TF32 products
  keep reading K-major operands;
- ``build(shape, dtype, device, seed)`` -- a ``Case``: inputs on the card,
  the wrapper's call and its plain version's output, and the tolerance the
  kernel is held to.

A candidate is measured through the public wrapper with a one-entry
database in place (``measure.py``), so what is timed is what dispatch
launches.  Families whose kernel has only compiled-in choices list the
default alone: the decode kernel ("ragged_paged_attention"), the conv
forward ("conv": its tiles are compiled in and its engine follows the
operands' shape) and the flash attention forward ("flash_attention": its
key tile is a template constant).  The matmul's tile width is compiled in
too; its family tunes the engine gate only.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

_SMS = 132   # an H100's SMs: the plans' default where no card is asked


class Case:
    """One family's inputs at a shape: ``run()`` calls the wrapper,
    ``want`` is the plain version's output, and an output is within
    tolerance where max|out - want| <= atol + rtol * max|want|."""

    def __init__(self, run: Callable[[], Any], want, atol: float,
                 rtol: float, pick: Callable[[Any], Any] = None):
        self.run = run
        self.want = want
        self.atol = atol
        self.rtol = rtol
        self.pick = pick or (lambda out: out)

    def error(self, out) -> Tuple[float, float]:
        """(max abs error of ``out`` against ``want``, its limit)."""
        got = self.pick(out).float()
        want = self.want.float()
        if got.shape != want.shape:
            return float("inf"), 0.0
        err = float((got - want).abs().max()) if want.numel() else 0.0
        if err != err:   # NaN
            err = float("inf")
        return err, self.atol + self.rtol * float(want.abs().max())


class Family:
    """One tunable kernel family: its search space and its harness."""

    def __init__(self, name: str, shape_names: Sequence[str],
                 default_shapes: Sequence[Tuple[int, ...]],
                 smoke_shapes: Sequence[Tuple[int, ...]],
                 configs: Callable[..., List[Dict[str, Any]]],
                 build: Callable[..., Case], dtypes=("float32",),
                 note: str = ""):
        self.name = name
        self.shape_names = tuple(shape_names)
        self.default_shapes = [tuple(s) for s in default_shapes]
        self.smoke_shapes = [tuple(s) for s in smoke_shapes]
        self.configs = configs
        self.build = build
        self.dtypes = tuple(dtypes)
        self.note = note


def _torch_dtype(dtype: str):
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]


def _randn(shape, dtype, device, gen, scale=1.0):
    import torch

    t = torch.randn(shape, generator=gen, dtype=torch.float32) * scale
    return t.to(device=device, dtype=_torch_dtype(dtype))


def _gen(seed: int):
    import torch

    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# matmul: (m, k, n) -> the wgmma engine's least M
# ---------------------------------------------------------------------------


def _matmul_configs(shape, dtype, sms=_SMS):
    from paddle_tpu_torch.kernels import matmul as km
    from paddle_tpu_torch.kernels.tuning.bucket import bucket_dim

    m, k, n = shape
    rule = (km.bf16_engine if dtype == "bfloat16" else km.f32_engine)
    if rule(m, k, n, 0, 0) != "wgmma":
        return []   # the gate cannot put a tile product on wgmma
    return [{"wgmma_min_rows": 2 * bucket_dim(m)}]


def _matmul_build(shape, dtype, device, seed=0):
    from paddle_tpu_torch.kernels import matmul as km

    m, k, n = shape
    g = _gen(seed)
    x = _randn((m, k), dtype, device, g)
    y = _randn((k, n), dtype, device, g)
    bf16 = dtype == "bfloat16"
    return Case(lambda: km.matmul(x, y), km.matmul_plain(x, y),
                atol=1e-5, rtol=1e-2 if bf16 else 1e-5)


# ---------------------------------------------------------------------------
# softmax: (rows, cols) -> (route, cluster)
# ---------------------------------------------------------------------------


def _softmax_configs(shape, dtype, sms=_SMS):
    from paddle_tpu_torch.kernels import softmax as ks

    rows, cols = shape
    default = ks.softmax_plan(cols, 0, 0)[:2]
    out = []
    for route in ("warp", "staged", "two-read"):
        for cluster in ((1,) if route == "warp"
                        else range(1, ks.MAX_CLUSTER + 1)):
            if (route, cluster) != default and ks.variant_ok(
                    route, cluster, cols, 0, 0):
                out.append({"route": route, "cluster": cluster})
    return out


def _softmax_build(shape, dtype, device, seed=0):
    from paddle_tpu_torch.kernels import softmax as ks

    g = _gen(seed)
    x = _randn(shape, dtype, device, g, 4.0)
    return Case(lambda: ks.softmax(x), ks.softmax_plain(x), atol=1e-6,
                rtol=0.0)


# ---------------------------------------------------------------------------
# flash attention forward: (bh, s, sk, d), the default alone
# ---------------------------------------------------------------------------


def _default_alone(shape, dtype, sms=_SMS):
    return []   # no launch parameter: the default alone


def _flash_build(shape, dtype, device, seed=0):
    from paddle_tpu_torch.kernels import flash_attention as kfa

    bh, s, sk, d = shape
    g = _gen(seed)
    q = _randn((1, s, bh, d), dtype, device, g)
    k = _randn((1, sk, bh, d), dtype, device, g)
    v = _randn((1, sk, bh, d), dtype, device, g)
    want = kfa.flash_attention_fwd_plain(q, k, v, tile=kfa.key_tile(d))[0]
    bf16 = dtype == "bfloat16"
    return Case(lambda: kfa.flash_attention_fwd(q, k, v), want,
                atol=1e-2 if bf16 else 1e-5, rtol=1e-2 if bf16 else 1e-5,
                pick=lambda out: out[0])


# ---------------------------------------------------------------------------
# conv forward: (n, h, w, c, o, k), the default alone
# ---------------------------------------------------------------------------


def _conv_build(shape, dtype, device, seed=0):
    from paddle_tpu_torch.kernels import conv as kc

    n, h, w, c, o, k = shape
    g = _gen(seed)
    x = _randn((n, h, w, c), dtype, device, g)
    wt = _randn((k, k, c, o), dtype, device, g, 0.05)
    bf16 = dtype == "bfloat16"
    return Case(lambda: kc.conv2d_nhwc(x, wt, k // 2),
                kc.conv2d_nhwc_plain(x, wt, k // 2),
                atol=1e-5, rtol=1e-2 if bf16 else 1e-5)


# ---------------------------------------------------------------------------
# conv filter gradient: (n, h, w, c, o, k) -> splits of the reduction
# ---------------------------------------------------------------------------


def _conv_dw_engine(shape, dtype):
    from paddle_tpu_torch.kernels import conv as kc

    n, h, w, c, o, k = shape
    if dtype == "bfloat16":
        return kc.bf16_engine(c, o, 0, 0)
    return kc.f32_dw_engine(c, o, 0, 0)


def _conv_dw_configs(shape, dtype, sms=_SMS):
    from paddle_tpu_torch.kernels import conv as kc

    n, h, w, c, o, k = shape
    tdt = _torch_dtype(dtype)
    engine = _conv_dw_engine(shape, dtype)
    kk = kc.dw_reduction(n, h, w, k // 2, tdt, engine)
    default = kc.dw_rule_plan(k * k * c, o, kk, tdt, engine)
    kstep = kc.dw_kstep(tdt, engine)
    seen, out = {default}, []
    s = 1
    while s <= 256:
        plan = kc.dw_split_chunk(kk, s, kstep)
        if plan not in seen and kc.dw_splits_ok(kk, *plan, tdt, engine):
            seen.add(plan)
            out.append({"splits": s, "engine": engine})
        s *= 2
    return out


def _conv_dw_build(shape, dtype, device, seed=0):
    from paddle_tpu_torch.kernels import conv as kc

    n, h, w, c, o, k = shape
    g = _gen(seed)
    x = _randn((n, h, w, c), dtype, device, g)
    gr = _randn((n, h, w, o), dtype, device, g)
    bf16 = dtype == "bfloat16"
    return Case(lambda: kc.conv2d_nhwc_dw(x, gr, k, k // 2),
                kc.conv2d_nhwc_dw_plain(x, gr, k, k // 2),
                atol=1e-4, rtol=1e-3 if bf16 else 1e-5)


# ---------------------------------------------------------------------------
# batch norm forward: (rows, cols) -> target blocks an SM, least rows a
# thread
# ---------------------------------------------------------------------------


def _bn_configs(shape, dtype, sms=_SMS):
    from paddle_tpu_torch.kernels import batch_norm as kb

    rows, cols = shape
    tdt = _torch_dtype(dtype)
    how = kb.route(cols, tdt, 0, 0)
    itemsize = kb._ITEMSIZE[tdt]
    seen = {kb.plan(rows, cols, itemsize, how)[5:7]}
    out = []
    for b in (1, 2, 4, 8, 16):
        for r in (2, 4, 8, 16, 32):
            p = kb.plan(rows, cols, itemsize, how, b, r)
            if kb.plan_ok(p) and p[5:7] not in seen:
                seen.add(p[5:7])
                out.append({"blocks_per_sm": b, "min_rows": r})
    return out


def _bn_build(shape, dtype, device, seed=0):
    from paddle_tpu_torch.kernels import batch_norm as kb

    rows, cols = shape
    g = _gen(seed)
    x = _randn((rows, cols), dtype, device, g, 2.0) + 0.5
    gamma = _randn((cols,), "float32", device, g)
    beta = _randn((cols,), "float32", device, g)
    want = kb.batch_norm_fwd_plain(x, gamma, beta, 1e-5)[0]
    bf16 = dtype == "bfloat16"
    return Case(lambda: kb.batch_norm_fwd(x, gamma, beta, 1e-5), want,
                atol=1e-2 if bf16 else 1e-4, rtol=0.0,
                pick=lambda out: out[0])


# ---------------------------------------------------------------------------
# lstm forward: (t, b, h) -> tile rows and cluster size
# ---------------------------------------------------------------------------


def _lstm_configs(shape, dtype, sms=_SMS):
    from paddle_tpu_torch.kernels import lstm as kl

    t, b, h = shape
    try:
        p = kl.plan(b, h, sms)
    except ValueError:
        return []
    out = []
    for rows in (4, 8):
        for cluster in (1, 2, 4, 8, 16):
            if (rows, cluster) == (p.rows, p.cluster):
                continue
            try:
                kl.plan(b, h, sms, rows=rows, cluster=cluster)
            except ValueError:
                continue
            out.append({"rows": rows, "cluster": cluster})
    return out


def _lstm_build(shape, dtype, device, seed=0):
    import torch

    from paddle_tpu_torch.kernels import lstm as kl

    t, b, h = shape
    g = _gen(seed)
    xproj = _randn((b, t, 4 * h), dtype, device, g, 0.5)
    w = _randn((h, 4 * h), "float32", device, g, 0.1)
    bias = _randn((4 * h,), "float32", device, g, 0.1)
    h0 = torch.zeros((b, h), dtype=xproj.dtype, device=device)
    c0 = torch.zeros_like(h0)
    want = kl.lstm_seq_plain(xproj, w, bias, h0, c0)[0]
    bf16 = dtype == "bfloat16"
    return Case(lambda: kl.lstm_seq(xproj, w, bias, h0, c0), want,
                atol=2e-2 if bf16 else 1e-4, rtol=0.0,
                pick=lambda out: out[0])


# ---------------------------------------------------------------------------
# paged attention: the decode kernel (s, p, page, h, d), default alone;
# the chunk (s, t, h, d, page, p) -> its span
# ---------------------------------------------------------------------------


def _paged_inputs(s, p, page, h, d, device, g, t=None):
    import torch

    n = s * p + 1
    q = _randn((s, h, d) if t is None else (s, t, h, d), "float32",
               device, g)
    k = _randn((n, page, h, d), "float32", device, g)
    v = _randn((n, page, h, d), "float32", device, g)
    tables = torch.arange(s * p, dtype=torch.int32).reshape(s, p)
    full = p * page if t is None else p * page - t
    lens = torch.randint(1, full + 1, (s,), generator=g,
                         dtype=torch.int64).to(torch.int32)
    return q, k, v, tables.to(device), lens.to(device)


def _rpa_build(shape, dtype, device, seed=0):
    from paddle_tpu_torch.kernels import paged_attention as kp

    s, p, page, h, d = shape
    args = _paged_inputs(s, p, page, h, d, device, _gen(seed))
    return Case(lambda: kp.paged_attention(*args),
                kp.paged_attention_plain(*args), atol=1e-4, rtol=0.0)


def _chunk_configs(shape, dtype, sms=_SMS):
    from paddle_tpu_torch.kernels import paged_attention as kp

    s, t, h, d, page, p = shape
    default = kp.chunk_plan(s, t, h, d, p, page, sms)[0]
    out = []
    span = 1
    while span <= p:
        if span != default and kp.span_ok(span, t, d, p):
            out.append({"span": span})
        span *= 2
    return out


def _chunk_build(shape, dtype, device, seed=0):
    from paddle_tpu_torch.kernels import paged_attention as kp

    s, t, h, d, page, p = shape
    args = _paged_inputs(s, p, page, h, d, device, _gen(seed), t=t)
    return Case(lambda: kp.paged_attention_chunk(*args),
                kp.paged_attention_chunk_plain(*args), atol=1e-4, rtol=0.0)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


# Each family's default shapes are ones a path of the port launches (the
# constants are chip_smoke.py's):
# - matmul: ResNet-50's fc at serving bucket 8 (phase 15s), the
#   transformer's attention projection at B 8, S 1024 (phases 8-9,
#   TF_BATCH x TF_SEQ rows of d_model 2048);
# - softmax: ResNet-50's classifier served at buckets 8 (phase 15s) and 32
#   (phases 3-4, SERVE_BATCH);
# - flash_attention: the transformer at B 8, S 1024, 16 heads of 128;
# - conv: ResNet-50's 3 x 3 convs of stages 1 and 3 served at bucket 8;
# - conv_dw: the same convs' filter gradients trained at TRAIN_BATCH 256
#   (phase 6, phase 2's training rows);
# - batch_norm: ResNet-50 trained at 256, its stem (256 x 112 x 112 rows
#   of 64) and its last stage (256 x 7 x 7 rows of 2048), phase 2's first
#   and last BN rows;
# - lstm: the LSTM classifier, T 100, B 64, H 256 (phases 11-12);
# - the paged kernels: the decode LM's 16 slots of 128 pages of 16 rows,
#   16 heads of 128 (phases 17-19), the chunk at the verify step's T 4.
SPACES: Dict[str, Family] = {
    "matmul": Family(
        "matmul", ("m", "k", "n"),
        default_shapes=[(8, 2048, 1000), (8192, 2048, 2048)],
        smoke_shapes=[(1024, 128, 128)],
        configs=_matmul_configs, build=_matmul_build,
        dtypes=("float32", "bfloat16"),
        note="the wgmma gate only: the tile width is compiled in"),
    "softmax": Family(
        "softmax", ("rows", "cols"),
        default_shapes=[(8, 1000), (32, 1000)],
        smoke_shapes=[(64, 1000), (16, 4096)],
        configs=_softmax_configs, build=_softmax_build),
    "flash_attention": Family(
        "flash_attention", ("bh", "s", "sk", "d"),
        default_shapes=[(128, 1024, 1024, 128)],
        smoke_shapes=[(2, 128, 128, 64)],
        configs=_default_alone, build=_flash_build,
        dtypes=("float32", "bfloat16"),
        note="the default alone: the key tile is a template constant"),
    "conv": Family(
        "conv", ("n", "h", "w", "c", "o", "k"),
        default_shapes=[(8, 56, 56, 64, 64, 3), (8, 14, 14, 256, 256, 3)],
        smoke_shapes=[(2, 8, 8, 64, 64, 3)],
        configs=_default_alone, build=_conv_build,
        dtypes=("float32", "bfloat16"),
        note="the default alone: the tiles are compiled in and the "
             "engine follows the operands' shape"),
    "conv_dw": Family(
        "conv_dw", ("n", "h", "w", "c", "o", "k"),
        default_shapes=[(256, 56, 56, 64, 64, 3),
                        (256, 14, 14, 256, 256, 3)],
        smoke_shapes=[(2, 8, 8, 64, 64, 3)],
        configs=_conv_dw_configs, build=_conv_dw_build,
        dtypes=("float32", "bfloat16")),
    "batch_norm": Family(
        "batch_norm", ("rows", "cols"),
        default_shapes=[(3211264, 64), (12544, 2048)],
        smoke_shapes=[(512, 128)],
        configs=_bn_configs, build=_bn_build,
        dtypes=("float32", "bfloat16")),
    "lstm": Family(
        "lstm", ("t", "b", "h"),
        default_shapes=[(100, 64, 256)],
        smoke_shapes=[(4, 16, 128)],
        configs=_lstm_configs, build=_lstm_build,
        dtypes=("float32", "bfloat16")),
    "ragged_paged_attention": Family(
        "ragged_paged_attention", ("s", "p", "page", "h", "d"),
        default_shapes=[(16, 128, 16, 16, 128)],
        smoke_shapes=[(8, 2, 8, 2, 8)],
        configs=_default_alone, build=_rpa_build,
        note="the default alone: the decode kernel has no launch "
             "parameter"),
    "ragged_paged_attention_chunk": Family(
        "ragged_paged_attention_chunk", ("s", "t", "h", "d", "page", "p"),
        default_shapes=[(16, 4, 16, 128, 16, 128)],
        smoke_shapes=[(2, 4, 2, 16, 8, 4)],
        configs=_chunk_configs, build=_chunk_build),
}

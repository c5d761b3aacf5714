"""The port's profile tools on the CPU: the round's phase spans, the
categories of ``commefficient_torch/scripts/round_profile.py`` against the
JAX package's ``scripts/tpu_profile.py`` scheme, the port's
``profile_diff`` against ``scripts/profile_diff.py`` byte for byte, and
the CPU self-test of ``round_profile.main``."""

import ast
import importlib.util
import io
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from commefficient_torch.scripts import bench_rounds  # noqa: E402
from commefficient_torch.scripts import profile_diff as t_diff  # noqa: E402
from commefficient_torch.scripts import round_profile as rp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
D = 6_568_640


def _jax_diff():
    # plain Python; loaded from its file so that the JAX script's
    # directory does not go on sys.path
    spec = importlib.util.spec_from_file_location(
        "jax_profile_diff", ROOT / "scripts" / "profile_diff.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_DIFF = _jax_diff()


def _annotations(path: Path):
    """The span names a module passes to ``annotate``."""
    return {n.args[0].value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Call) and getattr(n.func, "id", None)
            == "annotate" and n.args and isinstance(n.args[0], ast.Constant)}


def _jax_scheme():
    """The JAX script's category keys (``_category``'s table) and its
    counter registry's keys, read with ``ast``: importing the script
    would set its TPU cache environment on this process."""
    tree = ast.parse((ROOT / "scripts" / "tpu_profile.py").read_text())
    keys, counters = [], []
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "_category":
            for t in ast.walk(node):
                if isinstance(t, ast.Tuple) and len(t.elts) == 2 and \
                        isinstance(t.elts[1], ast.Constant):
                    keys.append(t.elts[1].value)
            keys.append(ast.literal_eval(node.body[-1].value))
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "COUNTERS":
            counters = [row[0] for row in ast.literal_eval(node.value)]
    return keys, counters


def _governing(name: str, budgets: dict):
    hits = [p for p in budgets if p.lower() in name.lower()]
    return max(hits, key=len) if hits else None


@pytest.fixture(scope="module")
def tiny_round():
    return bench_rounds.build_round([], num_clients=16, device="cpu",
                                    tiny=True)


def test_port_round_names_the_phase_spans(tiny_round):
    """One port round on the CPU under ``torch.profiler`` carries the
    client and server phase spans, as the JAX round's ``annotate`` calls
    name them; every span name of both aggregators is in ANNOTATIONS."""
    from torch.profiler import ProfilerActivity, profile

    _, _, _, _, one_round = tiny_round
    batch = bench_rounds.synthetic_batch()
    one_round(batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        one_round(batch)
    names = {e.name for e in prof.events()}
    assert {"fed_client_phase", "fed_server_phase"} <= names
    jax_spans = _annotations(
        ROOT / "commefficient_tpu" / "federated" / "aggregator.py")
    port_spans = _annotations(
        ROOT / "commefficient_torch" / "federated" / "aggregator.py")
    assert jax_spans == port_spans == {
        "fed_client_phase", "fed_server_phase", "fed_offload_gather"}
    engine = _annotations(
        ROOT / "commefficient_torch" / "federated" / "engine.py")
    assert set(rp.ANNOTATIONS) == port_spans | engine
    assert len(rp.ANNOTATIONS) == 5


ELEMENTWISE_MUL = (
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "AUnaryFunctor<float, float, float, at::native::binary_internal::"
    "MulFunctor<float> >, std::array<char*, 2ul> >(int, at::native::"
    "AUnaryFunctor<float, float, float, at::native::binary_internal::"
    "MulFunctor<float> >, std::array<char*, 2ul>)")
ELEMENTWISE_COPY = (
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "(anonymous namespace)::direct_copy_kernel_cuda(at::TensorIteratorBase&)"
    "::{lambda()#3}::operator()() const::{lambda()#7}::operator()() const::"
    "{lambda(float)#1}, std::array<char*, 2ul> >(int, ...)")
FILL = ("void at::native::vectorized_elementwise_kernel<4, at::native::"
        "FillFunctor<float>, std::array<char*, 1ul> >(int, at::native::"
        "FillFunctor<float>, std::array<char*, 1ul>)")
FLAT = [[D], [D], []]
PLANE = [[14, 3666, 128], []]
LEAVES = [[[1728], [64], [73728], [128], [147456], [128]] * 8, [], [D]]

# (kernel name, launching ops innermost first, the op's shapes, server
# phase) -> category
CASES = [
    ("void sketch_accumulate_kernel<true>(float const*, long, long)", (),
     (), False, rp.CLIENT_ACCUM),
    ("_Z24sketch_accumulate_kernelILb1EEvPKfllPf", (), (), False,
     rp.CLIENT_ACCUM),
    ("void sketch_accumulate_kernel<false>(float const*, long, long)", (),
     (), True, rp.PORT),
    ("_Z24sketch_accumulate_kernelILb0EEvPKfllPf", (), (), False, rp.PORT),
    ("sketch_estimates_kernel(float const*, int, int, float*)", (), (),
     True, rp.EPILOGUE),
    ("fused_epilogue_kernel(float const*, int, float*)", (), (), True,
     rp.EPILOGUE),
    ("topk_count_ge_kernel(unsigned int const*, long, int*)", (), (), True,
     rp.EPILOGUE),
    ("topk_descent_kernel(unsigned int const*, long, long, int*)", (), (),
     True, rp.EPILOGUE),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, "
     "float, false, true, (cudnnKernelDataType_t)2>(...)", ("aten::"
     "cudnn_convolution",), (), False, rp.CONV),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x16_warpgroupsize1x1x1_g1_execute_segment_k_off_"
     "kernel__5x_cudnn", (), (), False, rp.CONV),
    ("sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_f32f32_f32_nhwckrsc_"
     "nhwc_tilesize64x64x8_stage3_warpsize1x4x1_g1_execute_kernel__5x_"
     "cudnn", (), (), False, rp.CONV),
    ("void xmma_cudnn_infer::implicit_gemm::strided_dgrad_indexed::kernel"
     "<...>(...)", (), (), False, rp.CONV),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", ("aten::mm",), (), False,
     rp.MATMUL),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nn_align1>("
     "cutlass_80_simt_sgemm_128x128_8x4_nn_align1::Params)", ("aten::addmm",
     ), (), False, rp.MATMUL),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32_"
     "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas", (), (),
     False, rp.MATMUL),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     ("nccl:all_gather", "c10d::allgather_"), (), True, rp.TRANSMIT),
    ("ncclDevKernel_ReduceScatter_Sum_f32_RING_LL(ncclDevKernelArgsStorage"
     "<4096ul>)", ("nccl:reduce_scatter",), (), True, rp.TRANSMIT),
    ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
     ("nccl:all_to_all", "c10d::alltoall_"), (), True, rp.TRANSMIT),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage"
     "<4096ul>)", ("nccl:all_reduce", "c10d::allreduce_"), (), False,
     rp.COLLECTIVES),
    ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
     ("nccl:send",), (), False, rp.COLLECTIVES),
    ("Memcpy HtoD (Pinned -> Device)", ("aten::copy_", "aten::_to_copy"),
     [[8, 8, 32, 32, 3], [8, 8, 32, 32, 3], []], False, rp.MOVEMENT),
    ("Memset (Device)", (), (), False, rp.MOVEMENT),
    ("Memcpy DtoD (Device -> Device)", ("aten::copy_",), FLAT, False,
     rp.CLIENT_MOVE),
    ("Memcpy DtoD (Device -> Device)", ("aten::copy_", "aten::clone"), FLAT,
     True, rp.EPILOGUE),
    (ELEMENTWISE_MUL, (), (), False, rp.ELEMENTWISE),
    (ELEMENTWISE_MUL, ("aten::mul",), [[64, 3, 3, 3], []], True,
     rp.ELEMENTWISE),
    (ELEMENTWISE_MUL, ("aten::mul",), FLAT[1:], False, rp.ELEMENTWISE),
    (ELEMENTWISE_MUL, ("aten::mul",), FLAT[1:], True, rp.EPILOGUE),
    (ELEMENTWISE_MUL, ("aten::mul",), PLANE, True, rp.EPILOGUE),
    (ELEMENTWISE_COPY, ("aten::copy_", "aten::_to_copy", "aten::to"), FLAT,
     False, rp.CLIENT_MOVE),
    (ELEMENTWISE_COPY, ("aten::copy_",), [[512, 256, 3, 3]] * 2, False,
     rp.MOVEMENT),
    (FILL, ("aten::fill_", "aten::zero_", "aten::new_zeros"), PLANE, False,
     rp.CLIENT_MOVE),
    (FILL, ("aten::fill_",), [[5, 500096], []], True, rp.ELEMENTWISE),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>"
     "(...)", ("aten::cat",), LEAVES, False, rp.CLIENT_MOVE),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>"
     "(...)", ("aten::cat",), [[[64], [64]], []], False, rp.MOVEMENT),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::func_wrapper_t<float, at::native::sum_functor<float, "
     "float, float>::operator()(at::TensorIterator&)::{lambda(float, float)"
     "#1}>, unsigned int, float, 4, 4> >(...)", ("aten::sum",), (), False,
     rp.REDUCE),
    ("void at::native::(anonymous namespace)::distribution_elementwise_"
     "grid_stride_kernel<float, 4, ...normal_and_transform...>(...)", (),
     (), False, rp.RNG),
    ("void at::native::bitonicSortKVInPlace<2, -1, 16, 16, float, long, "
     "...>(...)", (), (), False, rp.SORT),
    ("void at::native::index_elementwise_kernel<128, 4, at::native::"
     "gpu_index_kernel<at::native::index_kernel_impl<...> >(...)", (), (),
     False, rp.GATHER),
    ("void at::native::index_elementwise_kernel<128, 4, at::native::"
     "gpu_index_kernel<at::native::index_put_kernel_impl<...> >(...)", (),
     (), False, rp.SCATTER),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 8, ...>"
     "(...)", (), (), False, rp.SCATTER),
    ("void at::native::unrolled_elementwise_kernel<...>(...)", (), (),
     False, rp.ELEMENTWISE),
    ("void some_library_kernel<float>(float*)", (), (), False, rp.OTHER),
]


@pytest.mark.parametrize("name, ops, shapes, server, want", CASES)
def test_cuda_kernel_categories(name, ops, shapes, server, want):
    assert rp.category(name, ops, shapes, server) == want


def test_port_scheme_keeps_the_keys_the_gates_read():
    """Every JAX category key that a preset or the counter registry reads
    exists in the port's scheme: letter for letter where a counter reads
    it, else with the same name before its unit in parentheses, and each
    preset's budget governs it as it governs the JAX key."""
    keys, counters = _jax_scheme()
    assert len(keys) >= 15 and len(counters) == 4
    assert [c for c, *_ in rp.COUNTERS] == counters
    assert set(J_DIFF._PRESETS) == set(t_diff._PRESETS)
    assert J_DIFF._PRESETS == t_diff._PRESETS

    def base(k):
        return k.split(" (")[0]

    read = [k for k in keys if k in counters or any(
        _governing(k, b) for b in J_DIFF._PRESETS.values())]
    assert len(read) >= 8
    for k in read:
        if k in counters or k in rp.CATEGORIES:
            assert k in rp.CATEGORIES, k
            port = k
        else:
            same = [c for c in rp.CATEGORIES
                    if base(c) == base(k) and c not in counters]
            assert len(same) == 1, (k, same)
            port = same[0]
        for preset, budgets in J_DIFF._PRESETS.items():
            assert _governing(port, budgets) == _governing(k, budgets), \
                (preset, k, port)


def _profile(scale: dict = None, rounds: int = 10) -> rp.RoundProfile:
    """A capture with every category of the port's scheme nonzero (and
    the named categories' spans scaled)."""
    scale = scale or {}
    spans = []
    for i, cat in enumerate(rp.CATEGORIES):
        for j in range(rounds * (1 + i % 3)):
            us = 1000.0 * (i + 1) * scale.get(cat, 1.0)
            spans.append(rp.Span(f"kernel_{i}_{j % 2}", us, cat, True,
                                 False))
    spans.append(rp.Span("sketch_estimates_kernel(...)", 25.0, rp.EPILOGUE,
                         False, True))
    return rp.RoundProfile(rounds, 150.0 * rounds, "cuda", spans)


def _write(prof, path: Path) -> str:
    return rp.write_report(prof, str(path), "fused CIFAR federated round",
                           rp.geometry_of("cifar", D, []),
                           "on `NVIDIA H100 80GB HBM3, 700.00 W`")


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_no_preset_is_vacuous_on_a_port_capture(tmp_path):
    cap = _write(_profile(), tmp_path / "a.md")
    parsed = t_diff.parse_capture(cap)
    assert set(parsed.categories) == set(rp.CATEGORIES)
    assert all(ms > 0 for _, ms in parsed.categories.values())
    for preset in sorted(t_diff._PRESETS):
        rc, out, err = _run(t_diff.main, [cap, cap, "--preset", preset])
        assert rc == 0 and "vacuous" not in err, (preset, err)


def _pairs(tmp_path):
    """(label, argv) pairs for both scripts."""
    meas = ROOT / "docs" / "measurements"
    jax_a, jax_b = str(meas / "tpu_profile.md"), str(
        meas / "tpu_profile_gpt2.md")
    legacy = tmp_path / "legacy.md"
    legacy.write_text(
        Path(jax_a).read_text().split("## Top 40 ops")[0]
        + "Server epilogue d-plane sweeps: **8.0 ops/round** (0.300 "
          "ms/round) — the sweep counter.\n"
          "Client flatten/movement (d-sized): **3.0 ops/round** (0.120 "
          "ms/round).\n")
    port_a = _write(_profile(), tmp_path / "port_a.md")
    port_b = _write(_profile({rp.CONV: 1.04, rp.MOVEMENT: 0.5}),
                    tmp_path / "port_b.md")
    pairs = [("jax", [jax_a, jax_b]), ("jax reversed", [jax_b, jax_a]),
             ("legacy", [str(legacy), jax_a]),
             ("legacy after", [jax_a, str(legacy)]),
             ("port", [port_a, port_b]),
             ("port budget", [port_a, port_b, "--fail-above-pct",
                              "convolution=1"])]
    pairs += [(f"jax {p}", [jax_a, jax_b, "--preset", p])
              for p in sorted(J_DIFF._PRESETS)]
    pairs += [(f"port {p}", [port_a, port_b, "--preset", p])
              for p in sorted(J_DIFF._PRESETS)]
    for preset, budgets in sorted(J_DIFF._PRESETS.items()):
        # grow each budget's governed category past its budget
        grow = {c: 1.0 + (pct + 20.0) / 100 for c in rp.CATEGORIES
                for pat, pct in budgets.items()
                if _governing(c, budgets) == pat}
        after = _write(_profile(grow), tmp_path / f"fail_{preset}.md")
        pairs.append((f"fails {preset}",
                      [port_a, after, "--preset", preset]))
    return pairs


def test_profile_diff_matches_the_jax_script(tmp_path):
    codes = {}
    for label, argv in _pairs(tmp_path):
        want = _run(J_DIFF.main, argv)
        got = _run(t_diff.main, argv)
        assert got == want, label
        codes[label] = got[0]
    assert codes["jax"] == codes["port"] == codes["legacy"] == 0
    assert codes["port budget"] == 1
    for preset in J_DIFF._PRESETS:
        assert codes[f"fails {preset}"] == 1, preset


def test_cpu_self_test_writes_a_capture(tmp_path, capsys):
    assert rp.main(["--device", "cpu", "--rounds", "2", "--out",
                    str(tmp_path)]) == 0
    path = tmp_path / "round_profile.md"
    cap = t_diff.parse_capture(str(path))
    assert cap.wall_ms > 0 and cap.busy_ms > 0
    assert sum(s for s, _ in cap.categories.values()) > 0
    assert set(cap.counters) == {slug for _, slug, _, _ in rp.COUNTERS}
    text = path.read_text()
    assert "NOT a device measurement" in text and "on the CPU" in text
    assert "## Top 40 ops" in text and "aten::" in text
    assert f"wrote {path}" in capsys.readouterr().out


def test_refusals(tmp_path, monkeypatch):
    with pytest.raises(SystemExit):
        rp.main(["--fused_epilogue", "--stream_sketch", "--device", "cpu",
                 "--out", str(tmp_path)])
    with pytest.raises(SystemExit):
        rp.main(["--target", "gpt2", "--device", "cpu", "--out",
                 str(tmp_path)])
    with pytest.raises(SystemExit):
        rp.main(["--device", "cpu", "--out", str(ROOT / "docs" / "torch")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        rp.main(["--rounds", "1", "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())


class _Ev:
    """A stand-in for a profiler ``FunctionEvent``."""

    def __init__(self, name, device_type, us=0.0, parent=None, shapes=(),
                 annotation=False, kernels=()):
        from torch.autograd import DeviceType

        self.name = name
        self.device_type = getattr(DeviceType, device_type)
        self.self_device_time_total = us
        self.self_cpu_time_total = us
        self.cpu_parent = parent
        self.input_shapes = list(shapes)
        self.is_user_annotation = annotation
        self.is_async = False
        self.kernels = [rp_kernel(n, d) for n, d in kernels]


def rp_kernel(name, duration):
    from torch.autograd.profiler_util import Kernel

    return Kernel(name, 0, duration)


def test_spans_of_attributes_device_events():
    """Each device event is bucketed through the host event that lists
    it (its parents give the server phase) and counted once, also where
    two host events list it; the spans' device mirrors are dropped, and a
    device event that no host event lists is counted as unattributed."""
    server = _Ev("fed_server_phase", "CPU", annotation=True,
                 kernels=[("sketch_estimates_kernel(float*)", 30.0)])
    mul = _Ev("aten::mul", "CPU", parent=server, shapes=FLAT[1:],
              kernels=[(ELEMENTWISE_MUL, 20.0)])
    client = _Ev("fed_client_phase", "CPU", annotation=True)
    cat = _Ev("aten::cat", "CPU", parent=client, shapes=LEAVES,
              kernels=[("CatArrayBatchedCopy<float>", 15.0)])
    twice = _Ev("aten::cat", "CPU", parent=client, shapes=LEAVES,
                kernels=[("CatArrayBatchedCopy<float>", 15.0)])
    events = [server, mul, client, cat, twice,
              _Ev("fed_server_phase", "CUDA", 60.0, annotation=True),
              _Ev("sketch_estimates_kernel(float*)", "CUDA", 30.0),
              _Ev(ELEMENTWISE_MUL, "CUDA", 20.0),
              _Ev("CatArrayBatchedCopy<float>", "CUDA", 15.0),
              _Ev("Memset (Device)", "CUDA", 5.0)]
    spans = rp.spans_of(events, cuda=True)
    got = sorted((s.name[:24], s.category, s.attributed, s.server)
                 for s in spans)
    assert got == sorted([
        ("sketch_estimates_kernel(", rp.EPILOGUE, False, True),
        (ELEMENTWISE_MUL[:24], rp.EPILOGUE, True, True),
        ("CatArrayBatchedCopy<floa", rp.CLIENT_MOVE, True, False),
        ("Memset (Device)", rp.MOVEMENT, False, False)])
    prof = rp.RoundProfile(1, 100.0, "cuda", spans)
    assert prof.busy_ms == pytest.approx(0.07)
    assert prof.unattributed_ms == pytest.approx(0.005)
    assert prof.kernels()["sketch_estimates"] == (1.0, pytest.approx(0.03))

"""The port's kvlint (`repro_torch.analysis`): fire / no-fire fixtures per
rule, suppression comments, the CLI and its baseline, parity with the
reference's rules on paired fixtures (a fault in its JAX idiom and in its
torch idiom), the step-root table against the reference's jit sites, and
the live port tree.

Stdlib only on the port's side: the analyzer imports neither torch nor
jax.  The reference's analyzer is stdlib too, so no test here needs jax.
"""
import ast
import json
import textwrap
from pathlib import Path

import pytest

from repro.analysis import run_paths as ref_run_paths
from repro.analysis.callgraph import ProjectIndex as RefProjectIndex
from repro.analysis.core import RULES as REF_RULES
from repro.analysis.core import load_files as ref_load_files
from repro_torch.analysis import kvlint
from repro_torch.analysis.callgraph import ProjectIndex, StepRoot
from repro_torch.analysis.core import RULES, load_files, run_paths
from repro_torch.analysis.rules_step import NO_COUNTERPART, STEP_ROOTS

REPO_ROOT = Path(__file__).resolve().parents[1]
ROOT = StepRoot("mod.py:0", "mod.py", "step")


def write(base: Path, files: dict):
    for rel, src in files.items():
        p = base / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def lint(tmp_path, files, rules=None, roots=(ROOT,)):
    """Write fixture files under tmp_path and run the port's analyzer."""
    write(tmp_path, files)
    return run_paths(sorted(files), tmp_path, rules, step_roots=roots)


def rules_of(findings):
    return [f.rule for f in findings]


# ---------------------------------------------------------------------------
# TK001 — step purity
# ---------------------------------------------------------------------------

TK001_FIRE = {
    "item": "y = x.item()",
    "cpu": "y = x.cpu()",
    "tolist": "y = x.tolist()",
    "numpy": "y = x.numpy()",
    "to_cpu": 'y = x.to("cpu")',
    "to_cpu_device": 'y = x.to(torch.device("cpu"))',
    "nonzero": "y = x.nonzero()",
    "torch_nonzero": "y = torch.nonzero(x)",
    "unique": "y = torch.unique(x)",
    "masked_select": "y = x.masked_select(x > 0)",
    "where_one_arg": "y = torch.where(x > 0)",
    "int": "y = int(x[0])",
    "float": "y = float(x.sum())",
    "bool": "y = bool(x.any())",
    "if": "if x.sum() > 0:\n        y = 1",
    "while": "while x.any():\n        x = x - 1",
    "assert": "assert (x > 0).all()",
    "ifexp": "y = 1 if x.any() else 2",
    "np_asarray": "y = np.asarray(x)",
    "print": 'print("step")',
    "cuda_synchronize": "torch.cuda.synchronize()",
    "event_synchronize": "ev.synchronize()",
    "upload": "y = torch.as_tensor(n_list, device=x.device)",
    "upload_tensor": "y = torch.tensor([1, 2], device=x.device)",
    "upload_to": "y = torch.from_numpy(arr).to(x.device)",
    "local_flow": "z = x * 2\n    y = z.item()",
    "tuple_flow": "a, b = x, 3\n    y = a.item()",
    "loop_flow": "for t in [x]:\n        y = t.item()",
    "container_flow": "ts = []\n    ts.append(x)\n    y = ts[0].item()",
    "cache_leaf": "y = cache.lengths.cpu()",
}

TK001_CLEAN = {
    "static_attrs": ("if x.shape[0] > 2 and x.ndim == 2 and x.is_cuda:\n"
                     "        y = x.dtype, x.device, x.requires_grad"),
    "static_methods": ("if x.size(0) + x.dim() + x.numel() > 2:\n"
                       "        y = x.stride(), x.is_contiguous()"),
    "none_test": "if cache is None:\n        y = 1",
    "membership": 'if "tokens" in cache:\n        y = 1',
    "len": "if len(x) > 2:\n        y = 1",
    "host_param": "if n > 2:\n        y = 1",
    "annotated_scalar": "if m > 2:\n        y = 1",
    "host_data": "h = np.zeros(3)\n    if h.any():\n        y = int(h[0])",
    "non_blocking_upload": ("y = torch.from_numpy(arr).pin_memory().to("
                            "x.device, non_blocking=True)"),
    "device_data_as_tensor": "y = torch.as_tensor(x, device=x.device)",
    "cpu_tensor": 'y = torch.as_tensor(arr, device="cpu")',
    "host_after_pull": "h = x.cpu()\n    ok = h.numpy()",
    "torch_op": "y = torch.where(x > 0, x, 0) + x.float().sum()",
}

TK001_TEMPLATE = """\
import numpy as np
import torch


def step(x, cache, n, m: int, ev, n_list, arr):
    {body}
    return x
"""
TK001_ROOT = StepRoot("mod.py:0", "mod.py", "step",
                      host=("n", "ev", "n_list", "arr"))


@pytest.mark.parametrize("case", sorted(TK001_FIRE))
def test_tk001_fires_on_each_host_sync(tmp_path, case):
    src = TK001_TEMPLATE.format(body=TK001_FIRE[case])
    findings = lint(tmp_path, {"mod.py": src}, ["TK001"], (TK001_ROOT,))
    assert rules_of(findings) == ["TK001"], findings


@pytest.mark.parametrize("case", sorted(TK001_CLEAN))
def test_tk001_host_data_and_metadata_do_not_fire(tmp_path, case):
    src = TK001_TEMPLATE.format(body=TK001_CLEAN[case])
    if case == "host_after_pull":      # the pull itself is the one finding
        findings = lint(tmp_path, {"mod.py": src}, ["TK001"], (TK001_ROOT,))
        assert [f.line for f in findings] == [6]
        return
    assert lint(tmp_path, {"mod.py": src}, ["TK001"], (TK001_ROOT,)) == []


def test_tk001_propagates_through_the_call_graph(tmp_path):
    src = """\
        def helper(v, k):
            if k > 0:
                return v
            return v.item()

        def unreachable(v):
            return v.item()

        def step(x):
            return helper(x, 3)
    """
    findings = lint(tmp_path, {"mod.py": src}, ["TK001"])
    assert [(f.rule, f.qualname, f.line) for f in findings] \
        == [("TK001", "helper", 4)]


def test_tk001_flows_through_returns_by_position(tmp_path):
    src = """\
        class Engine:
            def _pool(self, cache, layer: int):
                ring = layer > 2
                return (ring, layer) + (cache.k_pages_g,)

            def _page(self, cache):
                return cache.page_table_g.long()

            def step(self, cache):
                ring, j, pool = self._pool(cache, 0)
                if ring:
                    pool = pool * 2
                return self._page(cache).cpu()
    """
    root = StepRoot("mod.py:0", "mod.py", "Engine.step")
    findings = lint(tmp_path, {"mod.py": src}, ["TK001"], (root,))
    assert [f.line for f in findings] == [13]


def test_tk001_nonzero_result_stays_on_the_device(tmp_path):
    src = """\
        def step(active):
            rows = active.nonzero()[:, 0]
            return rows.cpu()
    """
    findings = lint(tmp_path, {"mod.py": src}, ["TK001"])
    assert [f.line for f in findings] == [2, 3]


# ---------------------------------------------------------------------------
# TK002 — a stale alias after an in-place step
# ---------------------------------------------------------------------------

TK002_STEP = """\
def step(cache, t):
    cache.lengths += t
    return cache


"""
TK002_FIRE = {
    "leaf": "old = cache.lengths\n    cache = step(cache, 1)\n    y = old + 1",
    "whole": "c = cache\n    step(cache, 1)\n    y = c",
    "view": ("pg = cache.k_pages_g[0]\n    cache = step(cache, 1)\n"
             "    y = pg.sum()"),
    "getattr": ('kp = getattr(cache, "k_pages_g")\n    step(cache, 1)\n'
                "    y = kp"),
    "loop": ("old = cache.lengths\n    for _ in range(3):\n"
             "        y = old + 1\n        step(cache, 1)"),
}
TK002_CLEAN = {
    "clone": ("old = cache.lengths.clone()\n    cache = step(cache, 1)\n"
              "    y = old + 1"),
    "rebound": ("old = cache.lengths\n    cache = step(cache, 1)\n"
                "    old = cache.lengths\n    y = old + 1"),
    "read_before": "old = cache.lengths\n    y = old + 1\n    step(cache, 1)",
    "host_copy": ("n = int(cache.lengths[0])\n    step(cache, 1)\n"
                  "    y = n + 1"),
}


def _tk002(body):
    return TK002_STEP + "def drive(cache):\n    " + body + "\n    return y\n"


@pytest.mark.parametrize("case", sorted(TK002_FIRE))
def test_tk002_fires_on_a_stale_alias(tmp_path, case):
    root = StepRoot("mod.py:0", "mod.py", "step", writes=("cache",))
    findings = lint(tmp_path, {"mod.py": _tk002(TK002_FIRE[case])},
                    ["TK002"], (root,))
    assert rules_of(findings) == ["TK002"], findings


@pytest.mark.parametrize("case", sorted(TK002_CLEAN))
def test_tk002_fresh_reads_do_not_fire(tmp_path, case):
    root = StepRoot("mod.py:0", "mod.py", "step", writes=("cache",))
    assert lint(tmp_path, {"mod.py": _tk002(TK002_CLEAN[case])},
                ["TK002"], (root,)) == []


def test_tk002_needs_a_step_that_writes_in_place(tmp_path):
    src = _tk002(TK002_FIRE["leaf"])
    assert lint(tmp_path, {"mod.py": src}, ["TK002"], (ROOT,)) == []


# ---------------------------------------------------------------------------
# TK003 — builds and compiles
# ---------------------------------------------------------------------------

TK003_FIRE = {
    "compile": "f = torch.compile(g)",
    "jit_script": "f = torch.jit.script(g)",
    "jit_trace": "f = torch.jit.trace(g, (x,))",
    "cpp_extension": "m = torch.utils.cpp_extension.load('m', ['m.cu'])",
    "cdll": "lib = ctypes.CDLL('lib.so')",
    "subprocess": "subprocess.run(['nvcc', 'k.cu'])",
    "graph_in_loop": "for _ in range(3):\n        gr = torch.cuda.CUDAGraph()",
    "build_in_loop": "for _ in range(3):\n        _build.build()",
}
TK003_TEMPLATE = """\
import ctypes
import subprocess

import torch
from repro_torch.kernels import _build


def setup(g, x):
    {body}
"""


@pytest.mark.parametrize("case", sorted(TK003_FIRE))
def test_tk003_fires_on_builds_outside_the_build_module(tmp_path, case):
    files = {"repro_torch/launch/setup.py":
             TK003_TEMPLATE.format(body=TK003_FIRE[case]),
             "repro_torch/kernels/_build.py": "def build():\n    pass\n"}
    findings = lint(tmp_path, files, ["TK003"])
    assert rules_of(findings) == ["TK003"], findings


@pytest.mark.parametrize("case", ["cdll", "subprocess", "cpp_extension"])
def test_tk003_allows_builds_in_the_build_module(tmp_path, case):
    files = {"repro_torch/kernels/_build.py":
             TK003_TEMPLATE.format(body=TK003_FIRE[case])}
    assert lint(tmp_path, files, ["TK003"]) == []


def test_tk003_fires_on_a_build_on_the_step_path(tmp_path):
    files = {
        "repro_torch/kernels/_build.py": "def build():\n    pass\n",
        "mod.py": """\
            import torch
            from repro_torch.kernels import _build

            def launch(x):
                _build.build()
                return x

            def warm_up():
                _build.build()

            @torch.compile
            def fused(x):
                return x

            def step(x):
                return launch(x)
        """}
    findings = lint(tmp_path, files, ["TK003"])
    assert [(f.rule, f.line) for f in findings] \
        == [("TK003", 5), ("TK003", 11)]


# ---------------------------------------------------------------------------
# TK004 — pool-write discipline
# ---------------------------------------------------------------------------

TK004_FIRE = {
    "subscript": "cache.k_pages_g[0, 1] = val",
    "local_alias": "pages = cache.v_pages_g\n    pages[0] = val",
    "index_put_": "cache.k_pages.index_put_((idx,), val)",
    "copy_": "cache.k_scale_g[0].copy_(val)",
    "fill_": "cache.page_table_g.fill_(0)",
    "zero_": "cache.v_scale_w.zero_()",
    "scatter_": "cache.k_pages_w.scatter_(0, idx, val)",
    "augassign": "pool += val",
    "augassign_subscript": "cache.k_pages_g[idx] += val",
    "pool_param": "pool[idx] = val",
    "getattr_alias": 'leaf = getattr(cache, "k_pages_g")\n    leaf[idx] = val',
}
TK004_TEMPLATE = """\
def write(cache, pool, val, idx, out):
    {body}
    return cache
"""


@pytest.mark.parametrize("case", sorted(TK004_FIRE))
def test_tk004_fires_outside_paged_kv(tmp_path, case):
    src = TK004_TEMPLATE.format(body=TK004_FIRE[case])
    findings = lint(tmp_path, {"core/engine2.py": src}, ["TK004"])
    assert rules_of(findings) == ["TK004"], findings


@pytest.mark.parametrize("case", ["subscript", "index_put_", "pool_param"])
def test_tk004_allows_writes_inside_paged_kv(tmp_path, case):
    src = TK004_TEMPLATE.format(body=TK004_FIRE[case])
    assert lint(tmp_path, {"core/paged_kv.py": src}, ["TK004"]) == []


@pytest.mark.parametrize("body", [
    "out[idx] = val", "out.copy_(val)", "x = cache.k_pages_g[idx] + val",
    "cache.lengths += 1", "cache.page_pos_w[idx] = val"])
def test_tk004_ignores_non_pool_tensors_and_reads(tmp_path, body):
    src = TK004_TEMPLATE.format(body=body)
    assert lint(tmp_path, {"core/engine2.py": src}, ["TK004"]) == []


# ---------------------------------------------------------------------------
# TK005 — kernel hygiene
# ---------------------------------------------------------------------------

TK005_WRAPPER = """\
    import torch
    from repro_torch.kernels import PLAIN_DEVICES
    from repro_torch.kernels._build import LaunchCount, entry

    launches = LaunchCount()


    def _raise_on(rc):
        if rc != 0:
            raise RuntimeError(rc)


    def op_cuda(x):
        if x.device.type != "cuda":
            raise ValueError("a CUDA tensor")
        _raise_on(entry("kvnand_op")(x.data_ptr()))
        launches.value += 1
        return x


    def op(x):
        if x.device.type in PLAIN_DEVICES:
            return x
        return op_cuda(x)
"""
TK005_PY_FIRE = {
    "is_available": ("    return op_cuda(x)",
                     "    if not torch.cuda.is_available():\n"
                     "        return x\n    return op_cuda(x)"),
    "device_branch": ("    if x.device.type in PLAIN_DEVICES:",
                      '    if x.device.type == "cpu":'),
    "is_cuda_branch": ("    if x.device.type in PLAIN_DEVICES:",
                       "    if not x.is_cuda:"),
    "try_entry": ('    _raise_on(entry("kvnand_op")(x.data_ptr()))',
                  '    try:\n        _raise_on(entry("kvnand_op")'
                  '(x.data_ptr()))\n    except RuntimeError:\n'
                  '        return x'),
    "rc_unchecked": ('    _raise_on(entry("kvnand_op")(x.data_ptr()))',
                     '    rc = entry("kvnand_op")(x.data_ptr())'),
    "rc_via_local": ('    _raise_on(entry("kvnand_op")(x.data_ptr()))',
                     '    fn = entry("kvnand_op")\n    fn(x.data_ptr())'),
    "no_count": ("    launches.value += 1\n", ""),
    "matmul": ("        return x\n    return op_cuda(x)",
               "        return x\n    return torch.matmul(x, x)"),
    "at": ("        return x\n    return op_cuda(x)",
           "        return x\n    return x @ x"),
    "sdpa": ("        return x\n    return op_cuda(x)",
             "        return x\n    return torch.nn.functional."
             "scaled_dot_product_attention(x, x, x)"),
}


@pytest.mark.parametrize("case", sorted(TK005_PY_FIRE))
def test_tk005_fires_in_kernel_wrappers(tmp_path, case):
    old, new = TK005_PY_FIRE[case]
    src = textwrap.dedent(TK005_WRAPPER)
    assert old in src
    files = {"kernels/op/kernel.py": src.replace(old, new, 1)}
    findings = lint(tmp_path, files, ["TK005"])
    assert rules_of(findings) == ["TK005"], findings


def test_tk005_clean_wrapper_passes(tmp_path):
    assert lint(tmp_path, {"kernels/op/kernel.py": TK005_WRAPPER},
                ["TK005"]) == []


def test_tk005_library_calls_are_kernel_modules_only(tmp_path):
    # the backward in torch ops (kernels/*/autograd.py) is no kernel
    old, new = TK005_PY_FIRE["matmul"]
    src = textwrap.dedent(TK005_WRAPPER).replace(old, new, 1)
    assert lint(tmp_path, {"kernels/op/autograd.py": src}, ["TK005"]) == []
    assert lint(tmp_path, {"serving/notakern.py": src}, ["TK005"]) == []


TK005_CU = """\
    #include <cstdio>
    // printf("a comment is no call");
    __global__ void __launch_bounds__(128) k(float* x) {
      x[threadIdx.x] = 0.f;
    }
    __device__ float twice(float v) { return 2.f * v; }
    extern "C" int kvnand_k(float* x, cudaStream_t s) {
      k<<<1, 128, 0, s>>>(x);
      return static_cast<int>(cudaGetLastError());
    }
    int host_log() { printf("host side\\n"); return 0; }
"""
TK005_CU_FIRE = {
    "no_launch_bounds": ("__global__ void __launch_bounds__(128) k(",
                         "__global__ void k("),
    "device_printf": ("{ return 2.f * v; }",
                      '{ printf("%f", v); return 2.f * v; }'),
    "kernel_printf": ("x[threadIdx.x] = 0.f;",
                      'x[threadIdx.x] = 0.f; printf("x");'),
    "no_last_error": ("return static_cast<int>(cudaGetLastError());",
                      "return 0;"),
    "launch_ex": ("k<<<1, 128, 0, s>>>(x);\n  return static_cast<int>"
                  "(cudaGetLastError());",
                  "cudaLaunchKernelEx(&cfg, k, x);\n  return 0;"),
}


@pytest.mark.parametrize("case", sorted(TK005_CU_FIRE))
def test_tk005_fires_in_cuda_sources(tmp_path, case):
    old, new = TK005_CU_FIRE[case]
    src = textwrap.dedent(TK005_CU)
    assert old in src
    findings = lint(tmp_path, {"csrc/k.cu": src.replace(old, new, 1)},
                    ["TK005"])
    assert rules_of(findings) == ["TK005"], findings


def test_tk005_clean_cuda_source_passes(tmp_path):
    assert lint(tmp_path, {"csrc/k.cu": TK005_CU}, ["TK005"]) == []


def test_tk005_cuda_suppression_comment(tmp_path):
    old, new = TK005_CU_FIRE["no_launch_bounds"]
    src = textwrap.dedent(TK005_CU).replace(
        old, "// kvlint: disable=TK005\n" + new, 1)
    assert lint(tmp_path, {"csrc/k.cuh": src}, ["TK005"]) == []


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

SUPPRESSED = {
    "own_line": ("y = x.item()  # kvlint: disable=TK001", []),
    "next_code_line": ("# kvlint: disable=TK001\n\n    # why\n"
                       "    y = x.item()", []),
    "other_rule": ("y = x.item()  # kvlint: disable=TK004", ["TK001"]),
    "reference_rule": ("y = x.item()  # kvlint: disable=KV001", ["TK001"]),
    "two_rules": ("y = x.item()  # kvlint: disable=TK004,TK001", []),
}


@pytest.mark.parametrize("case", sorted(SUPPRESSED))
def test_suppression_comments(tmp_path, case):
    body, want = SUPPRESSED[case]
    src = TK001_TEMPLATE.format(body=body)
    findings = lint(tmp_path, {"mod.py": src}, ["TK001"], (TK001_ROOT,))
    assert rules_of(findings) == want


def test_rule_ids_are_apart_from_the_reference():
    assert not set(RULES) & set(REF_RULES)
    assert RULES == tuple(f"TK00{i}" for i in range(1, 6))


# ---------------------------------------------------------------------------
# CLI + baseline round-trip
# ---------------------------------------------------------------------------

# the fixture stands at a STEP_ROOTS path, so the CLI's default roots reach
# it: three findings (a branch, a pull, a print)
CLI_FIXTURE = """\
    def sample_with_logprobs(logits, noise, *, true_vocab):
        if logits.sum() > 0:
            logits = logits + 1
        y = logits.item()
        print(y)
        return y
"""
CLI_PATH = "repro_torch/serving/sampler.py"


def write_fixture(tmp_path):
    write(tmp_path, {CLI_PATH: CLI_FIXTURE})
    return tmp_path / CLI_PATH


def test_cli_exit_codes_and_baseline_roundtrip(tmp_path, capsys):
    p = write_fixture(tmp_path)
    argv = [CLI_PATH, "--root", str(tmp_path), "--baseline", "bl.txt"]

    assert kvlint.main(argv) == 1            # live findings, no baseline
    assert kvlint.main(argv + ["--update-baseline"]) == 0
    text = (tmp_path / "bl.txt").read_text()
    assert text.count("TK001") == 3 and "TODO" in text
    capsys.readouterr()

    assert kvlint.main(argv) == 0            # everything grandfathered
    assert "baselined" in capsys.readouterr().out

    # a NEW violation is not covered by the baseline
    p.write_text(p.read_text() + "\n\ndef speculative_accept(l, d, s, p, a):"
                 "\n    return l.cpu()\n")
    assert kvlint.main(argv) == 1


def test_cli_baseline_keeps_justifications(tmp_path):
    write_fixture(tmp_path)
    argv = [CLI_PATH, "--root", str(tmp_path), "--baseline", "bl.txt"]
    assert kvlint.main(argv + ["--update-baseline"]) == 0
    bl = tmp_path / "bl.txt"
    bl.write_text(bl.read_text().replace("TODO: justify this entry",
                                         "known: the CPU path"))
    assert kvlint.main(argv + ["--update-baseline"]) == 0
    assert "TODO" not in bl.read_text()
    assert bl.read_text().count("known: the CPU path") == 3


@pytest.mark.parametrize("argv", [["--rules", "KV001"], ["--rules", "TK009"],
                                  ["--update-baseline", "--baseline",
                                   "none"]])
def test_cli_usage_errors(tmp_path, capsys, argv):
    write_fixture(tmp_path)
    assert kvlint.main([CLI_PATH, "--root", str(tmp_path)] + argv) == 2


def test_cli_rule_subset_and_clean_exit(tmp_path, capsys):
    write_fixture(tmp_path)
    assert kvlint.main([CLI_PATH, "--root", str(tmp_path), "--baseline",
                        "none", "--rules", "TK004,TK005"]) == 0
    assert "0 findings (2 rules" in capsys.readouterr().out


def test_cli_json_format(tmp_path, capsys):
    write_fixture(tmp_path)
    rc = kvlint.main([CLI_PATH, "--root", str(tmp_path),
                      "--baseline", "none", "--format", "json"])
    assert rc == 1
    payload = json.loads(capsys.readouterr().out)
    assert [f["line"] for f in payload] == [2, 4, 5]
    assert {f["rule"] for f in payload} == {"TK001"}
    assert all(not f["baselined"] and f["path"] == CLI_PATH
               for f in payload)


def test_baseline_key_survives_line_renumbering(tmp_path, capsys):
    p = write_fixture(tmp_path)
    argv = [CLI_PATH, "--root", str(tmp_path), "--baseline", "bl.txt"]
    assert kvlint.main(argv + ["--update-baseline"]) == 0
    # prepend an import: every finding moves down a line, keys hold
    p.write_text("import math\n" + p.read_text())
    assert kvlint.main(argv) == 0


# ---------------------------------------------------------------------------
# parity with the reference's rules
# ---------------------------------------------------------------------------

# (reference rule, JAX fixture, port rule, torch fixture, port roots, path):
# the same fault in each idiom, on the same line
PARITY = {
    "jit_item": ("KV001", """\
        import jax

        def step(x):
            y = x + 1
            return y.item()

        jitted = jax.jit(step)
    """, "TK001", """\
        import torch

        def step(x):
            y = x + 1
            return y.item()

        STEP = step
    """, (ROOT,), "mod.py"),
    "donation": ("KV002", """\
        import jax

        def _step(buf, t):
            return buf + t

        step = jax.jit(_step, donate_argnums=(0,))

        def drive(buf, t):
            out = step(buf, t)
            extra = buf + 1
            return out, extra
    """, "TK002", """\
        import torch
        def step(cache, t):
            cache.lengths += t
            return cache


        def drive(cache, t):
            old = cache.lengths
            out = step(cache, t)
            extra = old + 1
            return out, extra
    """, (StepRoot("mod.py:0", "mod.py", "step", writes=("cache",)),),
        "mod.py"),
    "pool_write": ("KV004", """\
        def bad_set(cache, val):
            pages = cache.k_pages_g
            return pages.at[0, 1].set(val)
    """, "TK004", """\
        def bad_set(cache, val):
            pages = cache.k_pages_g
            pages[0, 1] = val
    """, (), "core/engine2.py"),
    "kernel_purity": ("KV005", """\
        from jax.experimental import pallas as pl

        def _body(x_ref, o_ref):
            print("trace me")
            o_ref[...] = x_ref[...]

        def op(x):
            return pl.pallas_call(_body, out_shape=x)(x)
    """, "TK005", """\
        from repro_torch.kernels._build import LaunchCount, entry
        launches = LaunchCount()
        def op(x):
            try:
                _raise_on(entry("kvnand_op")(x.data_ptr()))
            except RuntimeError:
                return x
            launches.value += 1
            return x
    """, (), "kernels/badkern.py"),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_parity_with_the_reference_rules(tmp_path, case):
    ref_rule, jax_src, rule, torch_src, roots, rel = PARITY[case]
    write(tmp_path / "ref", {rel: jax_src})
    want = ref_run_paths([rel], tmp_path / "ref", [ref_rule])
    got = lint(tmp_path / "port", {rel: torch_src}, [rule], roots)
    assert [(f.rule, f.line) for f in want] == [(ref_rule, want[0].line)]
    assert [(f.rule, f.line) for f in got] == [(rule, want[0].line)]


# ---------------------------------------------------------------------------
# the step roots against the reference's jit sites
# ---------------------------------------------------------------------------

def _reference_jit_sites():
    index = RefProjectIndex(ref_load_files(["src/repro"], REPO_ROOT))
    out = set()
    for s in index.jit_sites:
        line = s.call.lineno if s.call is not None else s.target.node.lineno
        out.add(f"{s.ctx.rel.removeprefix('src/repro/')}:{line}")
    return out


def test_step_roots_cover_every_reference_jit_site():
    sites = _reference_jit_sites()
    assert len(sites) == 17
    mapped = {r.reference for r in STEP_ROOTS} | set(NO_COUNTERPART)
    assert sites == mapped, (sites - mapped, mapped - sites)
    assert all(reason.strip() for reason in NO_COUNTERPART.values())


def test_every_step_root_names_a_port_function():
    index = ProjectIndex(load_files(["src/repro_torch"], REPO_ROOT),
                         STEP_ROOTS)
    found = {r: fn for r, fn in index.roots}
    assert set(found) == set(STEP_ROOTS)
    assert len(index.roots) == len(set(STEP_ROOTS))    # each one function
    for root, fn in found.items():
        assert set(root.host) | set(root.writes) <= set(fn.params), root


# ---------------------------------------------------------------------------
# the live port tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def live_findings():
    return run_paths(["src/repro_torch", "chip_smoke.py"], REPO_ROOT)


def _line_of(rel: str, text: str) -> int:
    lines = (REPO_ROOT / rel).read_text().splitlines()
    hits = [i for i, line in enumerate(lines, start=1) if text in line]
    assert len(hits) == 1, (rel, text, hits)
    return hits[0]


@pytest.mark.parametrize("text", ["active.nonzero()", "n_write.cpu()"])
def test_tk001_reports_the_engines_known_host_syncs(live_findings, text):
    rel = "src/repro_torch/core/engine.py"
    line = _line_of(rel, text)
    assert any(f.rule == "TK001" and f.path == rel and f.line == line
               for f in live_findings)


def test_live_port_tree_has_zero_nonbaselined_findings(live_findings):
    assert live_findings, "the baseline's entries are findings"
    rc = kvlint.main(["src/repro_torch", "chip_smoke.py",
                      "--root", str(REPO_ROOT)])
    assert rc == 0, "kvlint found non-baselined findings in the port"
    text = (REPO_ROOT / kvlint.DEFAULT_BASELINE).read_text()
    entries = [line for line in text.splitlines()
               if line.strip() and not line.startswith("#")]
    assert entries and not any("TODO" in e for e in entries)
    assert all(len(e.split(None, 2)) == 3 for e in entries)


def test_analysis_package_imports_no_torch_jax_or_reference():
    pkg = REPO_ROOT / "src" / "repro_torch" / "analysis"
    files = sorted(pkg.glob("*.py"))
    assert len(files) == 7
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("torch", "jax", "jaxlib", "repro",
                                   "numpy"), (f.name, m)

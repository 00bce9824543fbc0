"""Parity of the port's static verifier (``repro_torch.core.pim.lint``) and
its ``verify=True`` gates with the JAX reference, on the CPU.

Counterparts of ``tests/test_pim_lint.py``. Programs cross between the
packages as pim-trace text (the same file for the fixtures), or are
hand-assembled from one op list in both packages where the builder and the
importer reject the stream. Tolerance: every diagnostic equal to the
reference's (code, severity, message, op index, trace line, slot); the
CLI's JSON report and exit codes equal; each gate raises ``LintError``
exactly when the reference's lint finds an error, with the same error
codes, and a verified run equals an unverified one bit for bit.
"""
import dataclasses
import glob
import importlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import pim as ref  # noqa: E402
from repro.core.pim import ir as ref_ir  # noqa: E402
from repro.core.pim import lint as ref_lint  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import pim as port  # noqa: E402
from repro_torch.core.pim import exec as port_exec  # noqa: E402
from repro_torch.core.pim import ir as port_ir  # noqa: E402
from repro_torch.core.pim import lint as port_lint  # noqa: E402
from test_torch_pim_core import (build_program,  # noqa: E402
                                 to_port_program)

# the packages re-export a `schedule` FUNCTION; the module needs importlib
ref_schedule = importlib.import_module("repro.core.pim.schedule")
port_schedule = importlib.import_module("repro_torch.core.pim.schedule")

ROWS = 16
WORDS = 2
FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "lint")
FIXTURES = sorted(glob.glob(os.path.join(FIXDIR, "*.trace")))
NAMES = [os.path.basename(p) for p in FIXTURES]
# fixture name -> op index the diagnostic must anchor to (trace op order);
# None = a whole-trace diagnostic (the pim405 equivalence proof has no op)
EXPECT_OP = {"pim103": 0, "pim104": 5, "pim106": 1, "pim201": 0,
             "pim202": 0, "pim203": 1, "pim204": 1, "pim301": 1,
             "pim302": 3, "pim303": 0, "pim401": 4, "pim402": 3,
             "pim403": 3, "pim404": 1, "pim405": None}
# The fixtures whose streams a gate must refuse (error severity).
HOSTILE = {"pim103.trace": "PIM103", "pim104.trace": "PIM104",
           "pim106.trace": "PIM106", "pim302.trace": "PIM302"}


def diags(report):
    return [dataclasses.asdict(d) for d in report.diagnostics]


def read(path):
    with open(path) as f:
        return f.read()


# ---------------------------------------------------------------------------
# Golden fixtures: the reference's report, diagnostic for diagnostic
# ---------------------------------------------------------------------------

def test_catalog_equals_the_reference():
    # codes, severities and titles; the port words one rationale anew
    assert {c: v[:2] for c, v in port_lint.CATALOG.items()} == \
        {c: v[:2] for c, v in ref_lint.CATALOG.items()}
    assert (port_lint.ERROR, port_lint.WARNING) == (ref_lint.ERROR,
                                                   ref_lint.WARNING)
    assert {f"pim{c}.trace" for c in
            (103, 104, 106, 201, 202, 203, 204, 301, 302, 303,
             401, 402, 403, 404, 405)} | {"clean_maj.trace"} <= set(NAMES)


@pytest.mark.parametrize("path", FIXTURES, ids=NAMES)
def test_fixture_report_equals_the_reference(path):
    want = ref_lint.lint_trace_file(path)
    got = port_lint.lint_trace_file(path)
    assert diags(got) == diags(want)
    assert got.render() == want.render()
    assert got.to_json() == want.to_json()
    text = read(path)
    for semantic in (False, True):
        assert diags(port_lint.lint_trace(text, semantic=semantic)) == \
            diags(ref_lint.lint_trace(text, semantic=semantic))


@pytest.mark.parametrize("path", FIXTURES, ids=NAMES)
def test_fixture_flags_expected_code_at_expected_op(path):
    directives = port_lint._trace_directives(read(path))
    assert directives == ref_lint._trace_directives(read(path))
    report = port_lint.lint_trace_file(path)
    name = os.path.basename(path).removesuffix(".trace")
    if "expect" not in directives:
        assert report.diagnostics == (), report.render()
        return
    code = directives["expect"]
    hits = [d for d in report.diagnostics if d.code == code]
    assert hits, f"{name}: {code} not in {report.codes()}"
    assert any(d.op_index == EXPECT_OP[name] for d in hits)
    for d in hits:
        assert d.severity == port_lint.CATALOG[code][0]


def test_fixture_diagnostics_carry_trace_line_provenance():
    report = port_lint.lint_trace(read(os.path.join(FIXDIR, "pim104.trace")))
    hit = next(d for d in report.diagnostics if d.code == "PIM104")
    assert hit.trace_line == 11
    assert f"line {hit.trace_line}" in hit.render()


def test_pimverify_directive_parsing_and_missing_ref(tmp_path):
    text = ("# pim-trace v2 rows=16 words=2 banks=1\n"
            "# pimlint: expect=PIM405\n"
            "# pimverify: equiv=nowhere.trace\n"
            "BANK 0 HOSTR 2\n")
    assert port_lint._trace_directives(text) == {"expect": "PIM405",
                                                 "equiv": "nowhere.trace"}
    t = tmp_path / "t.trace"
    t.write_text(text)
    got = port_lint.lint_trace_file(str(t))
    assert diags(got) == diags(ref_lint.lint_trace_file(str(t)))
    hit = next(d for d in got.diagnostics if d.code == "PIM405")
    assert hit.severity == port_lint.ERROR and "nowhere.trace" in hit.message


def test_pim405_witness_names_the_difference():
    report = port_lint.lint_trace_file(os.path.join(FIXDIR, "pim405.trace"))
    hit = next(d for d in report.diagnostics if d.code == "PIM405")
    assert hit.severity == port_lint.ERROR
    assert "NOT equivalent" in hit.message and "lane" in hit.message


def test_no_semantic_suppresses_pim4xx(capsys):
    path = os.path.join(FIXDIR, "pim404.trace")
    assert "PIM404" not in port_lint.lint_trace_file(
        path, semantic=False).codes()
    assert port_lint.main([path, "--no-semantic"]) == 1
    assert port_lint.main([path]) == 0
    capsys.readouterr()


# ---------------------------------------------------------------------------
# Program-level codes no trace can express, and schedule-level codes
# ---------------------------------------------------------------------------

def raw_pair(ops, payloads=(), rows=ROWS, words=WORDS):
    """One hand-assembled stream in both packages (bypassing the builder's
    and the importer's validation)."""
    pays = tuple(np.asarray(p, np.uint32) for p in payloads)
    return tuple(
        mod.PimProgram(ops=tuple(mod.PimOp(code, **kw) for code, kw in ops),
                       num_rows=rows, words=words, payloads=pays)
        for mod in (ref_ir, port_ir))


RAW = {
    "pim101": ([(ref_ir.OP_ROWCLONE, dict(a=3, b=ROWS + 2))], ()),
    "pim102": ([(ref_ir.OP_SHIFT, dict(a=0, b=1, delta=3))], ()),
    "pim103": ([(ref_ir.OP_TRA, dict(a=3, b=3, c=5))], ()),
    "pim105_missing": ([(ref_ir.OP_WRITE, dict(b=0, payload=4))], ()),
    "pim105_shape": ([(ref_ir.OP_WRITE, dict(b=0, payload=0))],
                     (np.zeros(WORDS + 1),)),
    "pim205": ([(ref_ir.OP_WRITE, dict(b=0, payload=0))],
               (np.zeros(WORDS), np.ones(WORDS))),
    "pim106_warning": ([(ref_ir.OP_FILL, dict(b=ROWS - 1, payload=0)),
                        (ref_ir.OP_ROWCLONE, dict(a=0, b=ROWS - 1))], ()),
}
RAW_CODE = {"pim101": ("PIM101", 0, False), "pim102": ("PIM102", 0, False),
            "pim103": ("PIM103", 0, False),
            "pim105_missing": ("PIM105", 0, False),
            "pim105_shape": ("PIM105", 0, False),
            "pim205": ("PIM205", None, True),
            "pim106_warning": ("PIM106", 1, True)}


@pytest.mark.parametrize("name", sorted(RAW))
@pytest.mark.parametrize("semantic", [False, True])
def test_program_level_codes(name, semantic):
    ops, payloads = RAW[name]
    r, p = raw_pair(ops, payloads)
    got = port_lint.lint_program(p, semantic=semantic)
    assert diags(got) == diags(ref_lint.lint_program(r, semantic=semantic))
    code, op_index, ok = RAW_CODE[name]
    d = next(d for d in got.diagnostics if d.code == code)
    assert d.op_index == op_index
    assert got.ok is ok


def layouts_pim305():
    out = []
    for mod in (ref, port):
        cfg = mod.paper_device(2, num_rows=32, words=8)
        wrong = mod.ProgramBuilder(16, 8)
        wrong.issue()
        out.append((cfg, [wrong.build(), None], {}))
    return out


def layouts_pim304():
    out = []
    for mod in (ref, port):
        cfg = mod.paper_device(2, num_rows=32, words=8)
        rng = np.random.default_rng(0)
        heavy = mod.ProgramBuilder(32, 8)
        for r in range(8):
            heavy.write_row(r, rng.integers(0, 2**32, 8, dtype=np.uint32))
        light = mod.ProgramBuilder(32, 8)
        light.issue()
        out.append((cfg, [heavy.build(), light.build()],
                    {"async_host": True}))
    return out


@pytest.mark.parametrize("case, code", [(layouts_pim305, "PIM305"),
                                        (layouts_pim304, "PIM304")])
@pytest.mark.parametrize("semantic", [False, True])
def test_schedule_level_codes(case, code, semantic):
    (cfg_r, lay_r, kw), (cfg_p, lay_p, _) = case()
    want = ref_lint.lint_schedule(cfg_r, lay_r, semantic=semantic, **kw)
    got = port_lint.lint_schedule(cfg_p, lay_p, semantic=semantic, **kw)
    assert diags(got) == diags(want)
    assert code in got.codes()
    if kw:      # the async analysis is opt-in
        assert code not in port_lint.lint_schedule(cfg_p, lay_p).codes()


# ---------------------------------------------------------------------------
# Builder and trace importer: the same validation and provenance
# ---------------------------------------------------------------------------

BUILDER_ERRORS = {
    "row": (lambda b: (b.rowclone(0, 1), b.rowclone(40, 1)), ValueError),
    "none": (lambda b: b.rowclone(None, 1), TypeError),
    "negative": (lambda b: b.rowclone(-(ROWS + 1), 0), ValueError),
    "delta": (lambda b: b.shift(0, 1, 2), ValueError),
    "payload": (lambda b: b.write_row(0, np.zeros(WORDS + 3, np.uint32)),
                ValueError),
    "scratch": (lambda b: b.ambit_xor(-3, 1, 2), ValueError),
}


@pytest.mark.parametrize("name", sorted(BUILDER_ERRORS))
def test_builder_validation_equals_the_reference(name):
    fn, exc = BUILDER_ERRORS[name]
    msgs = []
    for mod in (ref_ir, port_ir):
        with pytest.raises(exc) as ei:
            fn(mod.ProgramBuilder(ROWS, WORDS))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_importer_errors_and_trace_lines_equal_the_reference():
    bad = ("# pim-trace v2 rows=16 words=2 banks=1\n"
           "BANK 0 AAP 0 1\n"
           "BANK 0 SHIFT 0 1 +2\n")
    msgs = []
    for mod in (ref_ir, port_ir):
        with pytest.raises(ValueError, match="trace line 3") as ei:
            mod.from_trace_device(bad)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    text = ("# pim-trace v2 rows=16 words=2 banks=1\n"
            "\n"
            "BANK 0 AAP 0 1\n"
            "BANK 0 HOSTR 1\n")
    (prog,), = port_ir.from_trace_device(text)
    assert prog.trace_lines == (3, 4)
    b = port.ProgramBuilder(ROWS, WORDS)
    b.issue()
    assert b.build().trace_lines is None


# ---------------------------------------------------------------------------
# verify=True gates across the stack
# ---------------------------------------------------------------------------

def error_codes(report):
    return sorted({d.code for d in report.errors})


def _program_gates():
    return {
        "compile_program": lambda p: port.compile_program(p, verify=True),
        "execute": lambda p: port_exec.execute(p, verify=True,
                                               device="cpu"),
        "make_runner": lambda p: port_exec.make_runner(p, verify=True),
        "run_program": lambda p: port.run_program(
            port.make_subarray(p.num_rows, p.words, device="cpu"), p,
            verify=True),
    }


def _schedule_gates():
    def pipe(dev, layout):
        return port.schedule_pipeline(dev, [layout, layout], verify=True)

    def work(dev, layout):
        return port.schedule_workload(dev, [port.Phase.repeat(layout, 2)],
                                      verify=True)

    return {"schedule": lambda dev, lay: port.schedule(dev, lay,
                                                       verify=True),
            "schedule_pipeline": pipe, "schedule_workload": work}


SINGLE = [p for p in FIXTURES if read(p).splitlines()[0].endswith("banks=1")]


@pytest.mark.parametrize("gate", sorted(_program_gates()))
@pytest.mark.parametrize("path", SINGLE,
                         ids=[os.path.basename(p) for p in SINGLE])
def test_program_gates_on_fixtures(gate, path):
    """Each program gate raises LintError exactly when the reference's lint
    finds an error in the stream, with the reference's error codes."""
    text = read(path)
    (r,), = ref_ir.from_trace_device(text)
    (p,), = port_ir.from_trace_device(text)
    want = error_codes(ref_lint.lint_program(r))
    name = os.path.basename(path)
    if name in HOSTILE:
        assert HOSTILE[name] in want
    if want:
        with pytest.raises(port_lint.LintError) as ei:
            _program_gates()[gate](p)
        assert error_codes(ei.value.report) == want
    else:
        _program_gates()[gate](p)


@pytest.mark.parametrize("gate", sorted(_schedule_gates()))
@pytest.mark.parametrize("path", FIXTURES, ids=NAMES)
def test_schedule_gates_on_fixtures(gate, path):
    """The schedule gates over the fixture's own device (its header's
    geometry): LintError exactly when the reference's plan diagnostics hold
    an error, with its codes; silent on the clean streams."""
    text = read(path)
    layout_r = ref_ir.from_trace_device(text)
    layout_p = port_ir.from_trace_device(text)
    kw = dict(channels=1, ranks=1, banks_per_rank=len(layout_r),
              subarrays=len(layout_r[0]), num_rows=ROWS, words=WORDS)
    cfg_r, cfg_p = ref.DeviceConfig(**kw), port.DeviceConfig(**kw)
    flat = [p for bank in layout_r for p in bank]
    _, stripped, groups, deferred = ref_schedule._lower_step(cfg_r, flat)
    want = sorted({d.code for d in ref_lint._plan_diagnostics(
        cfg_r, stripped, groups, deferred, False)
        if d.severity == ref_lint.ERROR})
    name = os.path.basename(path)
    if name in HOSTILE:
        assert HOSTILE[name] in want
    dev = port.make_device(cfg_p, device="cpu")
    fn = _schedule_gates()[gate]
    if want:
        with pytest.raises(port_lint.LintError) as ei:
            fn(dev, [list(b) for b in layout_p])
        assert error_codes(ei.value.report) == want
    else:
        fn(dev, [list(b) for b in layout_p])


def test_builder_verify_gate():
    b = port.ProgramBuilder(ROWS, WORDS, verify=True)
    b.fill(0, 7)
    b.tra(0, 0, 2)            # PIM103 at build() time
    with pytest.raises(port_lint.LintError, match="PIM103"):
        b.build()
    ok = port.ProgramBuilder(ROWS, WORDS, verify=True)
    ok.fill(0, 7)
    ok.read_row(0)
    ok.build()                # warnings-only streams pass
    with pytest.raises(port_lint.LintError):
        port_ir.record(lambda b: b.tra(0, 0, 2), ROWS, WORDS, verify=True)


def test_verified_runs_equal_unverified_runs():
    """A gate that passes changes nothing: execute, run_program and
    schedule with verify=True give the unverified results bit for bit."""
    rng = np.random.default_rng(5)
    prog = to_port_program(build_program(rng, 20))
    assert port_lint.lint_program(prog).ok
    a = port_exec.execute(prog, verify=True, device="cpu")
    b = port_exec.execute(prog, device="cpu")
    for k, v in convert.to_numpy(a.state).items():
        assert np.array_equal(v, convert.to_numpy(b.state)[k]), k
    cfg = port.paper_device(2, num_rows=prog.num_rows, words=prog.words)
    dev = port.make_device(cfg, device="cpu")
    s1 = port.schedule(dev, [prog, prog], verify=True)
    s2 = port.schedule(dev, [prog, prog])
    assert torch.equal(s1.state.banks.bits, s2.state.banks.bits)
    assert torch.equal(s1.wall_ns, s2.wall_ns)
    assert [len(r) for r in s1.reads] == [len(r) for r in s2.reads]


def test_record_and_vm_thread_verify():
    from repro_torch.core.bitplane.vm import PimVM
    vm = PimVM(32, num_rows=64, words=4, verify=True, device="cpu")
    assert vm._builder.verify is True
    a = vm.load(np.arange(4, dtype=np.uint32))
    vm.xor(a, a, a)
    assert list(vm.read(a)) == [0, 0, 0, 0]
    assert vm._builder.verify is True         # the flush's new builder
    sharded = PimVM(8, num_rows=64, words=4, n_banks=2, verify=True,
                    device="cpu")
    assert sharded._builder.verify is True


def test_schedule_workload_verify_gate_covers_warm_path():
    cfg = port.paper_device(2, num_rows=32, words=8)
    race = port.ProgramBuilder(32, 8)
    race.fill(0, 1)
    race.copy_row(0, 5, 1, 0)
    race.copy_row(0, 5, 1, 0)
    other = port.ProgramBuilder(32, 8)
    other.issue()
    phases = [port.Phase.repeat([race.build(), other.build()], 2)]
    with pytest.raises(port_lint.LintError, match="PIM302"):
        port.schedule_workload(port.make_device(cfg, device="cpu"), phases,
                               verify=True)
    # warm the plan unverified, then verify: the plan's cached lint still
    # raises
    port.schedule_workload(port.make_device(cfg, device="cpu"), phases)
    with pytest.raises(port_lint.LintError):
        port.schedule_workload(port.make_device(cfg, device="cpu"), phases,
                               verify=True)


def test_verified_warm_schedule_adds_no_work():
    cfg = port.paper_device(2, num_rows=32, words=8)
    rng = np.random.default_rng(3)
    progs = []
    for _ in range(cfg.n_slots):
        b = port.ProgramBuilder(32, 8)
        b.issue()
        b.write_row(0, rng.integers(0, 2**32, 8, dtype=np.uint32))
        b.shift(0, 1, +1)
        b.read_row(1)
        progs.append(b.build())
    res = port.schedule(port.make_device(cfg, device="cpu"), progs,
                        verify=True)                    # warm
    port.reset_stats()
    for _ in range(3):
        res = port.schedule(res.state, progs, verify=True)
    assert port_schedule.SCHED_STATS["dispatches"] == 3
    assert port_schedule.SCHED_STATS["plan_misses"] == 0
    assert port_schedule.SCHED_STATS["compile_misses"] == 0
    assert port_ir.COLUMN_STATS["builds"] == 0
    assert port_exec.RUNNER_STATS["traces"] == 0
    assert port.SEM_STATS["analyses"] == 0


def test_lint_program_results_are_cached(monkeypatch):
    b = port.ProgramBuilder(ROWS, WORDS)
    b.fill(0, 7)
    b.read_row(0)
    prog = b.build()
    r1 = port_lint.lint_program(prog)
    monkeypatch.setattr(port_lint, "_lint_columns",
                        lambda *a, **k: pytest.fail("cache miss: "
                                                    "_lint_columns re-ran"))
    assert port_lint.lint_program(prog).diagnostics == r1.diagnostics
    b2 = port.ProgramBuilder(ROWS, WORDS)
    b2.fill(0, 7)
    b2.read_row(0)
    assert port_lint.lint_program(b2.build()).diagnostics == r1.diagnostics


# ---------------------------------------------------------------------------
# Generated streams: clean ones lint error-free, injected hazards are found
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(12))
def test_generated_programs_lint_like_the_reference(seed):
    rng = np.random.default_rng(seed)
    r = build_program(rng, 1 + seed % 24)
    p = to_port_program(r)
    # both sides read the same trace text (trace-line provenance included)
    r = ref_ir.PimProgram.from_trace(r.to_trace())
    got = port_lint.lint_program(p)
    assert diags(got) == diags(ref_lint.lint_program(r))
    assert got.ok, got.render()
    bad_r = ref_ir.PimProgram(
        ops=r.ops + (ref_ir.PimOp(ref_ir.OP_TRA, a=1, b=1, c=2),),
        num_rows=r.num_rows, words=r.words, payloads=r.payloads)
    bad_p = port_ir.PimProgram(
        ops=p.ops + (port_ir.PimOp(port_ir.OP_TRA, a=1, b=1, c=2),),
        num_rows=p.num_rows, words=p.words, payloads=p.payloads)
    got = port_lint.lint_program(bad_p)
    assert diags(got) == diags(ref_lint.lint_program(bad_r))
    d = next(x for x in got.diagnostics if x.code == "PIM103")
    assert d.op_index == len(r.ops)


def test_buggy_pr1_xor_expansion_is_flagged_but_current_isnt():
    b = port.ProgramBuilder(ROWS, WORDS)
    b.fill(port.C0, 0)
    b.fill(port.C1, 0xFFFFFFFF)
    b.write_row(0, np.zeros(WORDS, dtype=np.uint32))
    b.write_row(1, np.ones(WORDS, dtype=np.uint32))
    b.ambit_xor(0, 1, 2)
    b.read_row(2)
    assert port_lint.lint_program(b.build()).ok
    with pytest.raises(ValueError, match="scratch"):
        port.ProgramBuilder(ROWS, WORDS).ambit_xor(port.T0, 1, 2)


def test_workload_and_proof_legs_equal_the_reference():
    got = port_lint._workload_reports() + port_lint._semantic_reports("cpu")
    want = ref_lint._workload_reports() + ref_lint._semantic_reports()
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert diags(g) == diags(w), name
        assert g.ok, (name, g.render())
        if name.startswith("sem:"):
            assert g.diagnostics == (), name


def test_lint_100k_ops_equals_the_reference():
    """The reference's 100k-op stream (its timing is printed by
    chip_smoke.py, not asserted here)."""
    n = 100_000
    rng = np.random.default_rng(0)
    srcs = rng.integers(0, 32, n)
    dsts = rng.integers(0, 32, n)
    reports = []
    for mod, lint in ((ref, ref_lint), (port, port_lint)):
        b = mod.ProgramBuilder(64, 4)
        b.fill(mod.C0, 0)
        for s, d in zip(srcs, dsts):
            b.rowclone(int(s), int(d))
        b.tra(1, 1, 2)                   # one seeded hazard at the tail
        reports.append(lint.lint_program(b.build()))
    assert diags(reports[1]) == diags(reports[0])
    hit = next(d for d in reports[1].diagnostics if d.code == "PIM103")
    assert hit.op_index == n + 1


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.core.pim.lint
# ---------------------------------------------------------------------------

def test_cli_fixtures_and_json_report(tmp_path, capsys):
    out_r, out_p = tmp_path / "r.json", tmp_path / "p.json"
    assert ref_lint.main(FIXTURES + ["--json", str(out_r)]) == 0
    assert port_lint.main(FIXTURES + ["--json", str(out_p)]) == 0
    got = json.loads(out_p.read_text())
    assert got == json.loads(out_r.read_text())
    bad = next(v for k, v in got.items() if k.endswith("pim103.trace"))
    assert any(d["code"] == "PIM103" for d in bad["diagnostics"])
    capsys.readouterr()


TRACES = {
    "bad": "BANK 0 TRA 3 3 5\n",
    "warn": "BANK 0 HOSTR 2\n",
    "parse": "BANK 0 FROB 1 2\n",
}


@pytest.mark.parametrize("args", [("bad",), ("warn",), ("warn", "--strict"),
                                  ("parse",), (), ("warn", "--no-semantic"),
                                  ("bad", "--expect", "PIM103"),
                                  ("warn", "--expect", "PIM103")])
def test_cli_exit_codes_equal_the_reference(tmp_path, capsys, args):
    argv = []
    for a in args:
        if a in TRACES:
            t = tmp_path / f"{a}.trace"
            t.write_text("# pim-trace v2 rows=16 words=2 banks=1\n"
                         + TRACES[a])
            argv.append(str(t))
        else:
            argv.append(a)
    want = ref_lint.main(argv)
    out_r = capsys.readouterr().out
    got = port_lint.main(argv)
    assert got == want
    assert capsys.readouterr().out == out_r
    assert got == {("bad",): 1, ("warn",): 0, ("warn", "--strict"): 1,
                   ("parse",): 1, (): 2}.get(tuple(args), got)


@pytest.mark.parametrize("extra", [(), ("--no-semantic",)])
def test_cli_workloads_leg(tmp_path, capsys, extra):
    out_r, out_p = tmp_path / "r.json", tmp_path / "p.json"
    assert ref_lint.main(["--workloads", *extra, "--json", str(out_r)]) == 0
    assert port_lint.main(["--workloads", "--device", "cpu", *extra,
                           "--json", str(out_p)]) == 0
    got = json.loads(out_p.read_text())
    assert got == json.loads(out_r.read_text())
    if not extra:
        assert {"sem:ambit_xor", "sem:shift_workload(256)",
                "sem:xor_reduce", "sem:gf.xtime", "sem:rs.encode"} <= \
            set(got)
    capsys.readouterr()

"""Hot host loops (pine_tpu_torch/prl/loop_jit.py) against pine_tpu's
loop_jit and against the port's own eager interpreter.

The scripts of tests/test_loop_jit.py run through both packages: the same
printed output as pine_tpu and as the port with PINE_NO_LOOPJIT=1 (the
float reductions, which the batched tier sums over float32 lanes and the
eager interpreter in float64, to rel 1e-4 as pine_tpu's test holds its own
tiers), the same tier engaged ("batch" or "seq", ``compiled_tiers``), the
bail cases left eager in both; the sequential tier's lowered function
gives the eager interpreter's values exactly; ``scenes/benchmark.pine`` at
1/100 of its outer loop prints the exact reference value through the
batched tier, whether the masked loop asks for live lanes every iteration
or every EXIT_CHECK; a PRL runtime error in a tier leaves the loop to the
eager interpreter, and torch's own errors propagate.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

SCRIPTS = {
    "collatz": (512, """
sum = 0;
for N in 0..3 {
    for n in 1..4000 {
        x = n;
        iter = 0;
        while (x != 1) {
            if (x % 2 == 0) { x = x / 2; }
            else { x = x * 3 + 1; }
            iter += 1;
        }
        sum += iter;
    }
}
println(sum);
"""),
    "loop_carried": (512, """
a = 1;
b = 0;
for i in 0..6000 {
    t = a + b;
    b = a;
    a = t % 1000003;
}
println(a, ' ', b);
"""),
    "slab_boundaries": (16, """
sum = 0;
for i in 5..258 { sum += i; }
println(sum);
"""),
    "step_range": (16, """
sum = 0;
for i in 2~3~2000 { sum += i; }
println(sum);
"""),
    "outer_reads": (512, """
fn body(k: i32): i32 {
    sum = 0;
    for i in 0..2000 { sum += i * k; }
    return sum;
}
println(body(1), ' ', body(7));
"""),
    "impure": (16, """
sum = 0;
for i in 0..40 {
    if (i % 20 == 0) { println('tick ', i); }
    sum += 1;
}
println(sum);
"""),
    "scene_mutation": (16, """
scene := Scene();
scene.add('d', Diffuse([0.5, 0.5, 0.5]));
n = 0;
for i in 0..64 {
    scene.add(Sphere([i * 1.0, 0, 0], 0.1), 'd');
    n += 1;
}
println(n);
"""),
    "nested_small": (512, """
sum = 0;
for i in 0..2000 {
    for k in 0..4 { sum += i + k; }
}
println(sum);
"""),
    "pure_fn": (512, """
fn f(x: i32): i32 { return x * x % 97; }
sum = 0;
for i in 0..3000 { sum += f(i); }
println(sum);
"""),
    "carried_floats": (512, """
x = 0.5;
m = 0;
for i in 0..3000 {
    x = x * 3.7 * (1.0 - x);
    if x > 0.5 { m += 1; } else { m -= 1; }
    y := x / 3 + i % 7;
    x = x + y * 0.0;
}
println(x, ' ', m);
"""),
}

FLOAT_SCRIPT = """
acc = 0.0;
v = [0.0, 0.0, 0.0];
for i in 0..3000 {
    acc += sin(i * 0.01) * 0.5;
    v += [i * 0.001, 1.0, cos(i * 0.02)];
}
println(acc);
println(v.x, ' ', v.y, ' ', v.z);
"""

HOT_WHILE = """
x = 0;
s = 0;
while x < 30000 {
    s = (s + x) % 1000003;
    x += 1;
}
println(x, ' ', s);
"""


def tiers(cache):
    """The tiers of the loop-AST cache entries that hold a compiled tier."""
    return sorted(k[0] for e in cache.values() for k in e if isinstance(k, tuple))


def run_port(src, monkeypatch, min_trip, no_jit=False):
    from pine_tpu_torch.prl import loop_jit
    from pine_tpu_torch.prl.interp import Interpreter

    loop_jit._CACHE.clear()
    monkeypatch.setattr(loop_jit, "MIN_TRIP", min_trip)
    if no_jit:
        monkeypatch.setenv("PINE_NO_LOOPJIT", "1")
    out = []
    itp = Interpreter(out=out.append, device="cpu")
    itp.run(src)
    monkeypatch.delenv("PINE_NO_LOOPJIT", raising=False)
    return out, itp, tiers(loop_jit._CACHE)


def run_jax(src, monkeypatch, min_trip):
    from pine_tpu.prl import loop_jit as jlj
    from pine_tpu.prl.interp import Interpreter as JInterp

    jlj._CACHE.clear()
    monkeypatch.setattr(jlj, "MIN_TRIP", min_trip)
    out = []
    itp = JInterp(out=out.append)
    itp.run(src)
    t = tiers(jlj._CACHE)
    jlj._CACHE.clear()
    return out, itp, t


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_scripts_match_pine_tpu_and_eager(name, monkeypatch):
    min_trip, src = SCRIPTS[name]
    got, _, t_port = run_port(src, monkeypatch, min_trip)
    eager, _, t_off = run_port(src, monkeypatch, min_trip, no_jit=True)
    assert got == eager and got and not t_off
    if name != "carried_floats":  # a script of the port's own: pine_tpu's tier is float32
        want, _, t_jax = run_jax(src, monkeypatch, min_trip)
        assert got == want
        assert t_port == t_jax, (t_port, t_jax)
    # one cache entry a compiled loop (collatz's inner loop, re-run for each N)
    expect = {"impure": [], "scene_mutation": [], "loop_carried": ["seq"],
              "carried_floats": ["seq"]}.get(name, ["batch"])
    assert t_port == expect, t_port


def test_float_and_vec_reductions(monkeypatch):
    got, itp, t_port = run_port(FLOAT_SCRIPT, monkeypatch, 512)
    _, itp_e, _ = run_port(FLOAT_SCRIPT, monkeypatch, 512, no_jit=True)
    _, itp_j, t_jax = run_jax(FLOAT_SCRIPT, monkeypatch, 512)
    assert t_port == t_jax == ["batch"]
    for other in (itp_e, itp_j):
        assert itp.get_var("acc") == pytest.approx(other.get_var("acc"), rel=1e-4)
        np.testing.assert_allclose(np.asarray(itp.get_var("v").data),
                                   np.asarray(other.get_var("v").data), rtol=1e-4)


def test_hot_while_continues_in_the_sequential_tier(monkeypatch):
    from pine_tpu.prl import interp as jinterp

    from pine_tpu_torch.prl import loop_jit

    monkeypatch.setattr(loop_jit, "WHILE_HOT_ITERS", 50)
    monkeypatch.setattr(jinterp, "_LOOP_HOT_ITERS", 50)
    got, _, t_port = run_port(HOT_WHILE, monkeypatch, 4096)
    want, _, t_jax = run_jax(HOT_WHILE, monkeypatch, 4096)
    eager, _, _ = run_port(HOT_WHILE, monkeypatch, 4096, no_jit=True)
    assert got == want == eager and t_port == t_jax == ["seq"]


def test_sequential_tier_runs_the_lowered_function(monkeypatch):
    """The tier's function is Python source over the loop's variables: the
    interpreter's evaluator is not entered while it runs."""
    from pine_tpu_torch.prl import loop_jit
    from pine_tpu_torch.prl.interp import Interpreter

    calls = []
    real = Interpreter.eval

    def counting(self, node, env):
        calls.append(node)
        return real(self, node, env)

    monkeypatch.setattr(Interpreter, "eval", counting)
    before = loop_jit.RUNS["seq"]
    got, _, t_port = run_port(SCRIPTS["loop_carried"][1], monkeypatch, 512)
    assert loop_jit.RUNS["seq"] == before + 1 and t_port == ["seq"]
    assert len(calls) < 50, len(calls)  # the script's own statements, not 6,000 iterations


@pytest.mark.parametrize("exit_check", [1, 8])
def test_benchmark_scene_at_one_hundredth(exit_check, monkeypatch):
    """The masked loop asking for live lanes every iteration or every 8:
    the same exact sum (finished lanes are masked)."""
    from pine_tpu_torch.bench_prl import PER_OUTER, run_prl
    from pine_tpu_torch.prl import trace_flow

    monkeypatch.setattr(trace_flow, "EXIT_CHECK", exit_check)
    out, wall, runs, syncs = run_prl("cpu", outer=1)
    assert out == [str(PER_OUTER)] and runs == {"batch": 1, "seq": 0} and syncs > 0


@pytest.mark.parametrize("tier", ["batch", "seq"])
@pytest.mark.parametrize("error", ["prl", "torch"])
def test_tier_errors_fall_back_or_propagate(tier, error, monkeypatch):
    """A PRL runtime error while a tier runs (a loop its lanes cannot take)
    leaves the loop to the eager interpreter, with the eager output; any
    other error (torch's, CUDA's, a fault of the port's traced ops)
    propagates instead of hiding behind the slow path."""
    from pine_tpu_torch.prl import loop_jit
    from pine_tpu_torch.prl.interp import PRLRuntimeError

    name = "slab_boundaries" if tier == "batch" else "loop_carried"
    min_trip, src = SCRIPTS[name]
    exc = PRLRuntimeError if error == "prl" else RuntimeError

    def failing(*args, **kwargs):
        raise exc("a tier failed")

    monkeypatch.setattr(loop_jit, "_run_batched" if tier == "batch" else "_run_sequential",
                        failing)
    before = dict(loop_jit.RUNS)
    if error == "prl":
        eager, _, _ = run_port(src, monkeypatch, min_trip, no_jit=True)
        got, _, _ = run_port(src, monkeypatch, min_trip)
        assert got == eager and loop_jit.RUNS == before
    else:
        with pytest.raises(RuntimeError, match="a tier failed"):
            run_port(src, monkeypatch, min_trip)

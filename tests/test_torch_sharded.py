"""The torch port's sharded engine (parallel/) against the JAX package.

Tables from ``ShardedSolver`` at S in {1, 2, 4, 8} shards on the CPU, in
the reference dtypes, equal the port's classic engine, the JAX package's
``Solver`` and its ``ShardedSolver`` on conftest's faked 8-device mesh;
the edges backward equals the lookup join and runs no sort or search;
``--table-out`` of ``--devices 4`` equals the JAX CLI's; and the exchange,
the mesh's device rule, the CLI's routing and the one-process retry hold
their contracts. Integers throughout: no tolerance.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from gamesmanmpi_tpu import cli as jax_cli
from gamesmanmpi_tpu.games import get_game as jax_get_game
from gamesmanmpi_tpu.parallel import ShardedSolver as JaxShardedSolver
from gamesmanmpi_tpu.resilience import faults as ref_faults
from gamesmanmpi_tpu.solve import Solver as JaxSolver
from gamesmanmpi_tpu_torch import cli
from gamesmanmpi_tpu_torch.core.bitops import SENTINEL, to_reference
from gamesmanmpi_tpu_torch.core.hashing import owner_shard_np
from gamesmanmpi_tpu_torch.games import Nim, get_game
from gamesmanmpi_tpu_torch.parallel import (
    ShardedSolver,
    backend_for,
    exchange,
    make_mesh,
    sharded,
)
from gamesmanmpi_tpu_torch.resilience import faults
from gamesmanmpi_tpu_torch.solve.engine import Solver, SolverError

SPECS = ["tictactoe", "subtract:total=21,moves=1-2-3", "nim:heaps=3-4-5",
         "chomp:w=3,h=3", "connect4:w=3,h=3,connect=3"]

_REF = {}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    ref_faults.clear()
    yield
    faults.clear()
    ref_faults.clear()


def references(spec):
    """(JAX Solver, JAX ShardedSolver over 8 shards, port classic) solves
    of `spec`, once per test process."""
    if spec not in _REF:
        _REF[spec] = (
            JaxSolver(jax_get_game(spec)).solve(),
            JaxShardedSolver(jax_get_game(spec), num_shards=8).solve(),
            Solver(get_game(spec), device="cpu").solve())
    return _REF[spec]


def assert_same_tables(got, ref):
    assert (got.value, got.remoteness, got.num_positions) == (
        ref.value, ref.remoteness, ref.num_positions)
    assert sorted(got.levels) == sorted(ref.levels)
    for k, want in ref.levels.items():
        t = got.levels[k]
        states = (to_reference(t.states, got.game)
                  if t.states.dtype == np.int64 else t.states)
        np.testing.assert_array_equal(states, np.asarray(want.states),
                                      err_msg=k)
        assert t.values.dtype == np.uint8
        np.testing.assert_array_equal(t.values, np.asarray(want.values),
                                      err_msg=k)
        np.testing.assert_array_equal(t.remoteness,
                                      np.asarray(want.remoteness), err_msg=k)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("spec", SPECS)
def test_tables_match_reference(spec, S):
    jax_single, jax_sharded, classic = references(spec)
    got = ShardedSolver(get_game(spec), num_shards=S, device="cpu",
                        paranoid=True).solve()
    for ref in (classic, jax_single, jax_sharded):
        assert_same_tables(got, ref)
    st = got.stats
    assert st["engine"] == "sharded" and st["shards"] == S
    assert st["misses"] == 0 and st["backend"] == "local"
    fast = get_game(spec).uniform_level_jump
    assert st["path"] == ("fast" if fast else "generic")
    assert st["backward_edges_levels"] == (st["levels"] - 1 if fast else 0)


@pytest.mark.parametrize("spec", ["tictactoe", "connect4:w=3,h=4,connect=3"])
def test_edges_backward_sorts_and_searches_nothing(spec, monkeypatch):
    """The edges backward resolves every level but the deepest with
    exchanges and gathers only; its tables equal the lookup join's."""
    solver = ShardedSolver(get_game(spec), num_shards=4, device="cpu")
    resolve = solver._resolve_edges
    calls = []

    def forbidden(name):
        def fail(*a, **k):
            raise AssertionError(f"{name} ran in the edges backward")
        return fail

    def guarded(*a, **k):
        with monkeypatch.context() as m:
            for name in ("sort", "argsort", "searchsorted", "unique",
                         "bucketize"):
                m.setattr(torch, name, forbidden(name))
            m.setattr(sharded, "lookup_window", forbidden("lookup_window"))
            m.setattr(sharded, "route_by_owner", forbidden("route_by_owner"))
            calls.append(1)
            return resolve(*a, **k)

    solver._resolve_edges = guarded
    edges = solver.solve()
    assert len(calls) == edges.stats["backward_edges_levels"]
    assert len(calls) == edges.stats["levels"] - 1
    monkeypatch.setenv("GAMESMAN_BACKWARD", "lookup")
    lookup = ShardedSolver(get_game(spec), num_shards=4, device="cpu",
                           paranoid=True).solve()
    assert lookup.stats["backward_edges_levels"] == 0
    assert_same_tables(edges, lookup)


def test_backward_knob_parses_strictly(monkeypatch):
    monkeypatch.setenv("GAMESMAN_BACKWARD", "fast")
    with pytest.raises(SolverError, match="GAMESMAN_BACKWARD"):
        ShardedSolver(get_game("tictactoe"), num_shards=2, device="cpu")


@pytest.mark.parametrize("mode", ["edges", "lookup"])
@pytest.mark.parametrize("spec", ["tictactoe", "nim:heaps=3-4-5"])
def test_blocked_backward_parity(spec, mode, monkeypatch):
    """Backward blocks of 64 rows give the same tables (the lookup join
    blocks; the edges resolve is gather-only and does not)."""
    monkeypatch.setenv("GAMESMAN_BACKWARD", mode)
    monkeypatch.setenv("GAMESMAN_BACKWARD_BLOCK", "64")
    solver = ShardedSolver(get_game(spec), num_shards=4, device="cpu",
                           paranoid=True)
    assert solver.backward_block == 64
    assert_same_tables(solver.solve(), references(spec)[2])


def test_store_tables_false_keeps_the_root_answer():
    full = ShardedSolver(get_game("tictactoe"), num_shards=4,
                         device="cpu").solve()
    lean = ShardedSolver(get_game("tictactoe"), num_shards=4, device="cpu",
                         store_tables=False).solve()
    assert (lean.value, lean.remoteness, lean.num_positions) == (
        full.value, full.remoteness, full.num_positions)
    assert sorted(lean.levels) == [0]  # the root level only
    assert lean.lookup(0) == full.lookup(0)


def test_device_store_budget_spills_to_host(monkeypatch):
    """Past GAMESMAN_DEVICE_STORE_MB the edges and level states wait in
    host RAM and come back for their level: same tables, edges still
    resolve every level."""
    monkeypatch.setenv("GAMESMAN_DEVICE_STORE_MB", "0")
    r = ShardedSolver(get_game("tictactoe"), num_shards=4,
                      device="cpu").solve()
    assert r.stats["edges_bytes_spilled"] > 0
    assert r.stats["states_bytes_spilled"] > 0
    assert r.stats["backward_edges_levels"] == r.stats["levels"] - 1
    assert_same_tables(r, references("tictactoe")[2])


def test_paranoid_raises_on_lookup_misses(monkeypatch):
    """A join that misses every child: paranoid raises at the first
    level; without it the misses are counted."""
    monkeypatch.setenv("GAMESMAN_BACKWARD", "lookup")

    def miss_all(keys, window):
        z = torch.zeros(keys.shape, dtype=torch.uint8)
        return z, z.to(torch.int32), z.to(torch.bool)

    monkeypatch.setattr(sharded, "lookup_window", miss_all)
    with pytest.raises(SolverError, match="consistency failures"):
        ShardedSolver(get_game("tictactoe"), num_shards=2, device="cpu",
                      paranoid=True).solve()
    r = ShardedSolver(get_game("tictactoe"), num_shards=2,
                      device="cpu").solve()
    assert r.stats["misses"] > 0


def test_level_contract_is_checked():
    """Children beyond max_level_jump are refused, not dropped."""
    game = Nim((3, 4, 5))
    game.max_level_jump = 1  # nim takes up to 5 from a heap
    with pytest.raises(SolverError, match="outside levels"):
        ShardedSolver(game, num_shards=2, device="cpu").solve()


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


def _npz(path):
    with np.load(path) as z:
        return {f: (z[f].dtype, z[f].tobytes()) for f in z.files}


@pytest.mark.parametrize("spec,answer", [
    ("tictactoe", ("TIE", 9, 5478)), ("nim:heaps=3-4-5", ("WIN", 11, 120))])
def test_cli_devices_table_out_matches_reference(spec, answer, tmp_path):
    """`solve GAME --device cpu --devices 4` prints the known answer, and
    its --table-out equals the JAX CLI's `--devices 4` on the faked mesh
    and the single-device port's, array for array."""
    port, ref, single = (tmp_path / n for n in ("p.npz", "r.npz", "s.npz"))
    rc, lines = _run(cli.main, ["solve", spec, "--device", "cpu",
                                "--devices", "4", "--table-out", str(port)])
    assert rc == 0
    value, rem, positions = answer
    assert lines[:5] == [f"game: {get_game(spec).name}", "devices: 4",
                         f"positions: {positions}", f"value: {value}",
                         f"remoteness: {rem}"]
    assert _run(jax_cli.main, ["solve", spec, "--devices", "4",
                               "--table-out", str(ref)])[0] == 0
    assert _run(cli.main, ["solve", spec, "--device", "cpu",
                           "--table-out", str(single)])[0] == 0
    assert _npz(port) == _npz(ref) == _npz(single)


@pytest.mark.parametrize("argv,needle", [
    (["--engine", "dense", "--devices", "2"], "not ported yet"),
    (["--devices", "2", "--checkpoint-dir", "CKPT"], "not ported yet"),
    (["--devices", "2", "--coordinator", "127.0.0.1:1"],
     "requires --num-processes and --process-id"),
    (["--devices", "3", "--coordinator", "127.0.0.1:1", "--num-processes",
      "2", "--process-id", "0"], "must be a multiple"),
])
def test_cli_refuses_unported_and_malformed_multi_device(argv, needle,
                                                         tmp_path, capsys,
                                                         monkeypatch):
    monkeypatch.delenv("GAMESMAN_COORDINATOR", raising=False)
    monkeypatch.delenv("GAMESMAN_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("GAMESMAN_PROCESS_ID", raising=False)
    argv = [str(tmp_path / "ck") if a == "CKPT" else a for a in argv]
    assert cli.main(["solve", "connect4:w=3,h=3,connect=3", "--device",
                     "cpu", *argv]) == 2
    captured = capsys.readouterr()
    assert needle in captured.err
    assert "positions:" not in captured.out
    assert not (tmp_path / "ck").exists()


def test_cli_compat_module_with_level_of_shards():
    """A compat module declaring level_of goes through the shim to the
    sharded engine with --devices 4."""
    rc, result = cli.solve_main(["solve", "examples/ref_games/chomp_33.py",
                                 "--device", "cpu", "--devices", "4"])
    assert rc == 0
    assert result.stats["engine"] == "sharded"
    assert result.stats["shards"] == 4
    assert (result.value, result.remoteness, result.num_positions) == (
        1, 5, 19)


@pytest.mark.parametrize("point,level", [
    ("sharded.forward", 2), ("sharded.backward", 3)])
def test_one_process_retry_matches_reference(point, level, monkeypatch):
    """A transient at a sharded fault point is retried in one process,
    with the reference's count on the same schedule, and changes no
    table."""
    monkeypatch.setenv("GAMESMAN_RETRY_BASE_SECS", "0")
    spec = f"{point}:transient:{level}"
    faults.configure(spec)
    got = ShardedSolver(get_game("tictactoe"), num_shards=4,
                        device="cpu").solve()
    ref_faults.configure(spec)
    ref = JaxShardedSolver(jax_get_game("tictactoe"), num_shards=4).solve()
    assert got.stats["retries"] == ref.stats["retries"] == 1
    assert_same_tables(got, references("tictactoe")[0])


class _AgreeingCoord:
    """A consensus stub whose every round decides what was proposed."""

    def __init__(self):
        self.tags = []

    def propose(self, tag, verdict):
        self.tags.append((tag, verdict))
        return verdict

    def close(self):
        pass


def test_collective_retry_rounds_and_lost_peer(monkeypatch):
    """In a world a transient inside the step goes through a post round
    (agreed: retried and counted), and a transport error from a lost
    peer is a CoordinatedAbort at once, with no retry."""
    from gamesmanmpi_tpu_torch.resilience.coordination import (
        CoordinatedAbort,
    )

    monkeypatch.setenv("GAMESMAN_RETRY_BASE_SECS", "0")
    solver = ShardedSolver(get_game("tictactoe"), num_shards=2,
                           device="cpu")
    solver.coord = _AgreeingCoord()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("UNAVAILABLE: injected transport hiccup")
        return "done"

    assert solver._retry("sharded.forward", flaky, level=3) == "done"
    assert solver.retries == 1
    assert [t for t, _ in solver.coord.tags] == [
        "sharded.forward:L3:a1:pre", "sharded.forward:L3:a1:post",
        "sharded.forward:L3:a2:pre"]

    def lost():
        raise RuntimeError("[../gloo/transport/tcp/pair.cc:534] "
                           "Connection closed by peer [127.0.0.1]:4242")

    with pytest.raises(CoordinatedAbort, match="peer lost"):
        solver._retry("sharded.backward", lost, level=5)
    assert solver.retries == 1


def test_collective_deadline_exits_124():
    """A step blocked past GAMESMAN_COLLECTIVE_TIMEOUT in a world (here a
    sleep standing in for a collective on a dead peer) ends the process
    with exit 124 and its progress on stderr."""
    import subprocess
    import sys

    code = (
        "import time\n"
        "from gamesmanmpi_tpu_torch.games import get_game\n"
        "from gamesmanmpi_tpu_torch.parallel import ShardedSolver\n"
        "s = ShardedSolver(get_game('tictactoe'), num_shards=2,"
        " device='cpu')\n"
        "s.num_processes, s.collective_timeout = 2, 0.3\n"
        "with s._collective_deadline('sharded.backward', 7):\n"
        "    time.sleep(30)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 124
    assert "collective deadline expired" in proc.stderr
    assert "'point': 'sharded.backward', 'level': 7" in proc.stderr


# ------------------------------------------------------- the exchange


def test_route_by_owner_buckets_by_owner_shard():
    rng = np.random.default_rng(7)
    flat = rng.integers(0, 1 << 62, size=1000, dtype=np.int64)
    flat[::7] = SENTINEL
    send, counts, order = sharded.route_by_owner(torch.from_numpy(flat), 4)
    real = flat[flat != SENTINEL]
    owners = owner_shard_np(real.astype(np.uint64), 4)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(owners, minlength=4))
    n = int(counts.sum())
    got = send[:n].numpy()
    assert (send[n:] == SENTINEL).all()
    np.testing.assert_array_equal(
        owner_shard_np(got.astype(np.uint64), 4), np.sort(owners))
    slots = sharded.reply_slots(order, counts).numpy()
    assert (slots[flat == SENTINEL] == -1).all()
    np.testing.assert_array_equal(got[slots[flat != SENTINEL]], real)


@pytest.mark.parametrize("S", [1, 3, 4])
def test_all_to_all_moves_exact_splits(S):
    """Destination-major in, source-major out; the reply (counts.T)
    lands back in the sender's layout."""
    rng = np.random.default_rng(S)
    counts = rng.integers(0, 6, size=(S, S))
    mesh = make_mesh(S, "cpu")
    parts = [torch.arange(counts[s].sum() + 2, dtype=torch.int64) + 100 * s
             for s in range(S)]  # two ignored trailing rows each
    got = exchange.all_to_all(mesh, parts, counts)
    off = np.concatenate([np.zeros((S, 1), int), counts.cumsum(1)], 1)
    for d in range(S):
        want = np.concatenate([parts[s][off[s, d]:off[s, d + 1]].numpy()
                               for s in range(S)])
        np.testing.assert_array_equal(got[d].numpy(), want)
    back = exchange.all_to_all(mesh, got, counts.T, "reply")
    for s in range(S):
        np.testing.assert_array_equal(back[s].numpy(),
                                      parts[s][:counts[s].sum()].numpy())
    moved = int(counts.sum() - np.trace(counts)) * 8
    assert mesh.traffic.bytes == {"route": moved, "reply": moved}
    assert mesh.traffic.calls == {"route": 1, "reply": 1}


def test_mesh_devices_and_backend_rule(monkeypatch):
    """Fewer cards than shards refuse with the reference's message unless
    GAMESMAN_FAKE_DEVICES allows them; the CPU takes any count; the
    backend is nccl only when every rank has a card of its own."""
    mesh = make_mesh(8, "cpu")
    assert (mesh.S, mesh.local, mesh.world) == (8, tuple(range(8)), 1)
    assert set(mesh.devices) == {torch.device("cpu")}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("GAMESMAN_FAKE_DEVICES", raising=False)
    with pytest.raises(ValueError,
                       match="requested 4 shards but only 1 devices"):
        make_mesh(4, "cuda")
    monkeypatch.setenv("GAMESMAN_FAKE_DEVICES", "4")
    assert make_mesh(4, "cuda").devices == (torch.device("cuda", 0),) * 4
    assert backend_for(torch.device("cpu"), 2) == "gloo"
    assert backend_for(torch.device("cuda"), 2) == "gloo"  # shared card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert backend_for(torch.device("cuda"), 2) == "nccl"
    assert make_mesh(4, "cuda").devices == tuple(
        torch.device("cuda", i % 2) for i in range(4))

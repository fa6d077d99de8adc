"""The plain reference and the frozen least-work count against counts
made by hand: a depth-first walk of the game from the empty board."""

import pytest
import torch

import reference
import work


def hand_walk(w, h, connect=4):
    """Every reachable position (packed) with its number of moves, and
    the (live position, move) pairs per level, by a plain walk."""
    h1 = h + 1

    def line(x):
        for d in (1, h, h1, h1 + 1):
            y = x
            for i in range(1, connect):
                y &= x >> (i * d)
            if y:
                return True
        return False

    seen = {}
    stack = [((0,) * w, 0, 0)]  # heights, stones to move, stones moved
    while stack:
        hs, mine, theirs = stack.pop()
        key = (hs, mine)
        if key in seen:
            continue
        level = sum(hs)
        moves = 0
        if not line(theirs):
            for c in range(w):
                if hs[c] < h:
                    moves += 1
                    bit = 1 << (c * h1 + hs[c])
                    nh = hs[:c] + (hs[c] + 1,) + hs[c + 1:]
                    stack.append((nh, theirs, mine | bit))
        seen[key] = (level, moves)
    reachable, pairs = {}, {}
    for level, moves in seen.values():
        reachable[level] = reachable.get(level, 0) + 1
        pairs[level] = pairs.get(level, 0) + moves
    return reachable, pairs


@pytest.mark.parametrize("w,h", [(3, 4), (4, 4)])
def test_least_work_matches_a_hand_count(w, h):
    reachable, pairs = hand_walk(w, h)
    sol = reference.Board(w, h).solve()
    assert sol.reachable == {L: reachable.get(L, 0)
                             for L in range(w * h + 1)}
    assert {L: v for L, v in sol.moves.items() if v} == \
        {L: v for L, v in pairs.items() if v}
    n, m = sum(reachable.values()), sum(pairs.values())
    ops, nbytes = work.least_work(sol.reachable, sol.moves, 4)
    assert ops == n * (1 + 20) + m * 4
    assert nbytes == n + (n - 1)
    assert work.fold_ops(4) == 20


@pytest.mark.parametrize("w,h,positions,value,remoteness", [
    (4, 4, 161029, reference.TIE, 16),
    (5, 4, 3945711, reference.TIE, 20),
])
def test_tromps_counts_and_root_answers(w, h, positions, value, remoteness):
    torch.set_num_threads(4)
    sol = reference.Board(w, h).solve()
    assert (sol.positions, sol.value, sol.remoteness) == \
        (positions, value, remoteness)


def test_pack_locate_and_rank_round_trip():
    b = reference.Board(4, 4)
    sol = b.solve()
    for L in (0, 5, 9, 16):
        flat = sol.reach[L].reshape(-1).nonzero().reshape(-1)
        row, rank = flat // b.size[L], flat % b.size[L]
        p1 = b.unrank(L, row, rank)
        to_move = p1 if L % 2 == 0 else b.filled[L][row] ^ p1
        states = b.pack(b.profiles[L][row], to_move)
        lvl, row2, rank2, _, ok = b.locate(states)
        assert ok.all() and (lvl == L).all()
        assert torch.equal(row2, row) and torch.equal(rank2, rank)


def test_checks_catch_a_changed_cell_and_a_wrong_answer():
    b = reference.Board(4, 4)
    sol = b.solve()
    cells = {L: c.clone() for L, c in sol.cells.items()}
    assert reference.check_solve(b, sol, cells, None, "cpu") == 0
    reach = sol.reach[7].reshape(-1)
    cells[7].reshape(-1)[int(reach.nonzero()[0])] ^= 4
    assert reference.check_solve(b, sol, cells, None, "cpu") == 1
    root = b.pack(torch.zeros((1, 4), dtype=torch.int64),
                  torch.zeros(1, dtype=torch.int64))
    kids, legal = b.children(root)
    assert legal.all()
    best = int(kids[0, 0])
    assert reference.check_answers(b, sol, root, ["TIE"], [16], [best]) == 0
    assert reference.check_answers(b, sol, root, ["TIE"], [15], [best]) == 1
    assert reference.check_answers(b, sol, root, ["WIN"], [16], [best]) == 1
    assert reference.check_answers(b, sol, root, ["TIE"], [16], [None]) == 1


def test_only_reachable_positions_are_judged():
    """A placeholder (an unreachable position's cell) may hold anything;
    the table form of the same solve reads the same count as its cells;
    a level that is in neither form counts its reachable positions."""
    from conftest import classic_tables

    b = reference.Board(4, 4)
    sol = b.solve()
    cells = {L: c.clone() for L, c in sol.cells.items()}
    for L, c in cells.items():
        c[~sol.reach[L]] ^= 4
    assert reference.check_solve(b, sol, cells, None, "cpu") == 0
    low = b.solve(remoteness_bits=4)
    n = reference.check_solve(b, sol, low.cells, None, "cpu")
    assert n > 0
    assert reference.check_solve(b, sol, None, classic_tables(b, low),
                                 "cpu") == n
    assert reference.check_solve(b, sol, None, classic_tables(b, sol),
                                 "cpu") == 0
    del cells[9]
    assert reference.check_solve(b, sol, cells, None, "cpu") == \
        sol.reachable[9]

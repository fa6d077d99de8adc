"""The order of a dense solve's downloads on the card (solve/dense.py
``LevelCopies``), checked on the CPU with recording streams and events.

A fake stream keeps its operations in order; an event records the last
operation enqueued on its stream, and a stream that waits on it makes
its next operation depend on that one (CUDA's ``cudaStreamWaitEvent``).
The solver's level loop is replayed over four levels: each level's
kernel on the kernels' stream, the release of the deeper level, the
level's download through ``LevelCopies``, and at the end a last release
and the root read. Then, by the dependencies alone:

- copy L follows kernel L;
- kernel L-1, the first work on the kernels' stream after level L+1 is
  released (its memory may be reused then), follows copy L+1, and does
  not wait for copy L, so copy L runs beside it;
- the root read follows every copy;
- the host waits only for a seal's copy.
"""

import pytest

from gamesmanmpi_tpu_torch.solve.dense import LevelCopies

LEVELS = 4


class Stream:
    def __init__(self, name, ops):
        self.name, self._ops = name, ops
        self.last = None
        self._after: set = set()

    def enqueue(self, label):
        """An operation on this stream: it depends on the stream's last
        operation and on every event waited on since."""
        deps = set(self._after) | ({self.last} if self.last else set())
        self._ops[label] = (self.name, deps)
        self.last, self._after = label, set()
        return label

    def wait_event(self, event):
        if event.mark is not None:
            self._after.add(event.mark)


class Event:
    def __init__(self, host_log):
        self.mark = None
        self._host_log = host_log

    def record(self, stream):
        self.mark = stream.last

    def synchronize(self):
        self._host_log.append(("wait", self.mark))


class Cells:
    def __init__(self, level):
        self.level = level


class Host:
    def __init__(self, current):
        self._current = current

    def copy_(self, cells, non_blocking=False):
        assert non_blocking
        self._current[0].enqueue(f"copy {cells.level}")


def _replay(seal=False, pageable=()):
    """The solver's loop over LEVELS levels -> (ops {label: (stream,
    deps)}, the host's log in order)."""
    ops, host_log = {}, []
    kernels, copies = Stream("kernels", ops), Stream("copies", ops)
    current = [kernels]

    def set_stream(stream):
        current[0] = stream

    order = LevelCopies(kernels, copies, Event(host_log), Event(host_log),
                        set_stream)
    for L in range(LEVELS - 1, -1, -1):
        host_log.append(("enqueue", kernels.enqueue(f"kernel {L}")))
        order.release()
        host_log.append(("release", L + 1))
        if L in pageable:  # the blocking .cpu() on the kernels' stream
            host_log.append(("wait", kernels.enqueue(f"pageable {L}")))
        else:
            order.copy(Host(current), Cells(L), wait=seal)
        assert current[0] is kernels
    order.release()  # the last level's copy, before the root read
    host_log.append(("enqueue", kernels.enqueue("root read")))
    return ops, host_log


def _after(ops, label) -> set:
    """Every operation `label` waits for, directly or not."""
    seen, todo = set(), list(ops[label][1])
    while todo:
        op = todo.pop()
        if op not in seen:
            seen.add(op)
            todo.extend(ops[op][1])
    return seen


@pytest.mark.parametrize("case", ["pinned", "sealed", "one_pageable"])
def test_each_copy_runs_under_the_next_kernel_and_before_its_reuse(case):
    pageable = {1} if case == "one_pageable" else set()
    ops, host_log = _replay(seal=case == "sealed", pageable=pageable)
    copied = [L for L in range(LEVELS) if L not in pageable]
    for L in copied:
        stream, _ = ops[f"copy {L}"]
        assert stream == "copies"
        assert f"kernel {L}" in _after(ops, f"copy {L}"), L
    released = [e[1] for e in host_log if e[0] == "release"]
    assert released == list(range(LEVELS, 0, -1))
    for L in range(LEVELS - 2, -1, -1):
        # Level L+1's memory may go to level L-1 once released: the
        # first work after it on the kernels' stream follows its copy.
        nxt = f"kernel {L - 1}" if L > 0 else "root read"
        i = host_log.index(("release", L + 1))
        assert ("enqueue", nxt) in host_log[i:], L
        if L + 1 in copied:
            assert f"copy {L + 1}" in _after(ops, nxt), L
        if L > 0 and L in copied:
            # ...and not copy L, which runs beside kernel L-1.
            assert f"copy {L}" not in _after(ops, nxt), L
    for L in copied:
        assert f"copy {L}" in _after(ops, "root read"), L
    waits = [e[1] for e in host_log if e[0] == "wait"]
    if case == "sealed":
        assert waits == [f"copy {L}" for L in range(LEVELS - 1, -1, -1)]
    else:
        assert waits == [f"pageable {L}" for L in sorted(pageable)]


def test_a_seal_waits_for_its_own_copy_before_the_next_kernel():
    """The sealed solve's host waits for copy L before it enqueues
    kernel L-1: a seal reads the bytes of its own level only."""
    _, host_log = _replay(seal=True)
    for L in range(LEVELS - 1, 0, -1):
        assert (host_log.index(("wait", f"copy {L}"))
                < host_log.index(("enqueue", f"kernel {L - 1}"))), L

"""``utils/bench.device_ms`` checks its premise, on the CPU.

``device_ms`` reads the card's own time per apply from applies queued
behind a sleep kernel: a time that holds only while the sleep outlasts
the host's queueing. Here ``torch.cuda``'s synchronize, events and sleep
are patched onto a simulated card with a host clock: the host spends
``host_ms`` queueing each apply, the card ``card_ms`` running it, an
event completes when the card reaches it, and with ``depth`` the host
can queue at most that many applies ahead of the card (CUDA's queue of
pending work), then waits. So every branch shows without a card: a
sample whose sleep outlasted the queueing gives the card's time exactly;
one whose sleep ended first is void, and is taken again with half the
applies that were queued in time (a slow host, a full queue), or with
one apply behind a sleep twice as long; past ``HOLD_CAP_CYCLES``
``device_ms`` raises ``HoldExpired`` and returns no number.
"""
import pytest
import torch

from loops_tpu_torch.utils import bench

CYCLES_PER_MS = 2e6  # the sleep's clock: 50M cycles are 25 ms


class FakeCard:
    """One stream and a host clock, in ms."""

    def __init__(self, host_ms, card_ms, depth=None):
        self.host_ms, self.card_ms, self.depth = host_ms, card_ms, depth
        self.now = 0.0      # the host's clock
        self.free = 0.0     # when the card has run all it was given
        self.starts = []    # when the card starts each apply queued
        self.sleeps = []

    def synchronize(self, device=None):
        self.now = max(self.now, self.free)

    def sleep(self, cycles):
        self.sleeps.append(cycles)
        self.free = max(self.now, self.free) + cycles / CYCLES_PER_MS

    def apply(self, x):
        self.now += self.host_ms
        pending = sorted(t for t in self.starts if t > self.now)
        if self.depth is not None and len(pending) >= self.depth:
            # a full queue: the launch returns once the card has taken
            # all but depth - 1 of the pending applies
            self.now = pending[len(pending) - self.depth]
        start = max(self.now, self.free)
        self.starts.append(start)
        self.free = start + self.card_ms
        return x

    def event(self, enable_timing=False):
        card = self

        class Event:
            def record(self):
                self.done = max(card.now, card.free)

            def query(self):
                return card.now >= self.done

            def synchronize(self):
                card.now = max(card.now, self.done)

            def elapsed_time(self, other):
                return other.done - self.done
        return Event()


@pytest.fixture
def card(monkeypatch):
    def make(host_ms, card_ms, depth=None):
        c = FakeCard(host_ms, card_ms, depth)
        monkeypatch.setattr(torch.cuda, "synchronize", c.synchronize)
        monkeypatch.setattr(torch.cuda, "_sleep", c.sleep)
        monkeypatch.setattr(torch.cuda, "Event", c.event)
        return c
    return make


def test_premise_holds_gives_the_card_time(card):
    c = card(host_ms=0.1, card_ms=1.0)  # 50 applies queued in 5 ms
    assert bench.device_ms(c.apply, torch.zeros(1)) == pytest.approx(1.0)
    assert c.sleeps == [bench.HOLD_CYCLES] * 3
    assert bench.held_sample(c.apply, torch.zeros(1), 50,
                             bench.HOLD_CYCLES) == (pytest.approx(1.0), 50)


def test_slow_host_is_void_and_retimed_with_fewer_applies(card):
    # the host queues an apply a ms: 25 fit in the 25 ms sleep, not 50
    c = card(host_ms=1.0, card_ms=0.3)
    x = torch.zeros(1)
    assert bench.held_sample(c.apply, x, 50, bench.HOLD_CYCLES) == (None,
                                                                     25)
    assert bench.device_ms(c.apply, x) == pytest.approx(0.3)
    assert c.sleeps == [bench.HOLD_CYCLES] * 5


def test_full_queue_is_void_at_any_hold_and_retimed(card):
    # the host may run 6 applies ahead: it then waits for the card, and
    # the sleep ends before the 50th is queued however long it is
    c = card(host_ms=0.01, card_ms=1.0, depth=6)
    x = torch.zeros(1)
    for hold in (bench.HOLD_CYCLES, bench.HOLD_CAP_CYCLES):
        ms, queued = bench.held_sample(c.apply, x, 50, hold)
        assert ms is None and queued == 7
    assert bench.device_ms(c.apply, x) == pytest.approx(1.0)


def test_unchecked_sample_would_misread(card):
    # what the unchecked procedure returned for the slow host: the span
    # from the sleep's end holds host gaps, not the card's time alone
    c = card(host_ms=1.0, card_ms=0.3)
    x = torch.zeros(1)
    c.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda._sleep(bench.HOLD_CYCLES)
    t0.record()
    for _ in range(50):
        c.apply(x)
    t1.record()
    t1.synchronize()
    assert t0.elapsed_time(t1) / 50 > 1.5 * 0.3


def test_one_slow_apply_gets_a_longer_hold(card):
    # one apply takes the host 100 ms: the sleep must last longer
    c = card(host_ms=100.0, card_ms=0.3)
    assert bench.device_ms(c.apply, torch.zeros(1)) == pytest.approx(0.3)
    h = bench.HOLD_CYCLES
    assert c.sleeps == [h, h, 2 * h, 4 * h, 8 * h, 8 * h, 8 * h]


def test_hold_past_the_cap_raises(card):
    # one apply takes the host 2 s, past the longest hold (1.6 s)
    c = card(host_ms=2000.0, card_ms=0.3)
    with pytest.raises(bench.HoldExpired, match="not measured"):
        bench.device_ms(c.apply, torch.zeros(1))
    assert c.sleeps[-1] == bench.HOLD_CAP_CYCLES
    assert c.sleeps == sorted(c.sleeps)

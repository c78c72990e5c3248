"""The whole-request window's arithmetic on a fake clock."""

from portbench import window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def run(seconds, durations):
    clock = Clock()

    def one(i):
        clock.t += durations[i]
        return i

    return window.run(seconds, one, clock)


def test_requests_start_only_while_they_fit():
    done, length = run(10.0, [3.0] * 10)
    # 0-3, 3-6, 6-9; a fourth would end at 12 > 10
    assert [d[2] for d in done] == [0, 1, 2] and length == 9.0
    assert window.seconds_per_request(done, length) == 3.0


def test_the_first_request_always_runs():
    done, length = run(10.0, [35.0, 1.0])
    assert len(done) == 1 and length == 35.0


def test_the_last_request_time_decides():
    # 0-4, 4-5 (4 + 4 <= 10), 5-9 (5 + 1 <= 10), then 9 + 4 > 10
    done, length = run(10.0, [4.0, 1.0, 4.0, 1.0])
    assert len(done) == 3 and length == 9.0
    assert [(d[0], d[1]) for d in done] == [(0.0, 4.0), (4.0, 5.0), (5.0, 9.0)]


def test_exactly_filling_the_window_counts():
    done, length = run(9.0, [3.0] * 5)
    assert len(done) == 3 and length == 9.0

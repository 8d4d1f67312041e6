"""chip_smoke.py's launch check over profiled windows (ProfiledWindows),
on windows written out by hand: a window that lost activity records may
see fewer launches than were counted and still pass, a launch seen that
was not counted fails, and each kernel needs two windows seen in full."""
import importlib.util

import pytest

from _torch_parity import ROOT


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", f"{ROOT}/chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _window(smoke, seen, ran, total):
    """(profiled, counted, ms, busy ms, kernels) as ProfiledWindows.stop
    records it; seen / ran give traverse_kernel and threefry_kernel."""
    def full(pair):
        counts = dict.fromkeys(smoke.GRAPH_KERNELS, 0)
        counts["traverse_kernel"], counts["threefry_kernel"] = pair
        return counts
    return (full(seen), full(ran), 10.0, 5.0, total)


@pytest.mark.parametrize("seen, agree, short", [
    # every window saw every counted launch
    ([(68, 152), (68, 152), (68, 152)], True, 0),
    # threefry seen in full in one window only
    ([(67, 152), (68, 140), (68, 150)], False, 3),
    # one window lost records of both kernels
    ([(67, 150), (68, 152), (68, 152)], True, 1),
    # each kernel seen in full in two windows, not the same two
    ([(68, 151), (68, 152), (66, 152)], True, 2),
    # a launch the counters missed
    ([(69, 152), (68, 152), (68, 152)], False, 0),
    # one window seen in full is not enough
    ([(68, 152), (60, 150), (68, 100)], False, 2),
])
def test_profiled_windows_launch_check(seen, agree, short):
    smoke = _smoke()
    windows = smoke.ProfiledWindows(libs=[])
    windows.windows = [
        _window(smoke, s, (68, 152), 40_111 - (68 - s[0]) - (152 - s[1]))
        for s in seen]
    assert windows.agree() is agree
    assert windows.short == short
    assert windows.counted["traverse_kernel"] == 68 * len(seen)
    assert windows.profiled["threefry_kernel"] == sum(s[1] for s in seen)
    # the device numbers sum only the windows with the largest total
    most = max(w[4] for w in windows.windows)
    kept = sum(w[4] == most for w in windows.windows)
    assert windows.kernels == most * kept
    assert windows.lossy == len(seen) - kept
    assert "windows short of some kernel's records" in windows.describe()


def test_profiled_windows_one_window_never_agrees():
    smoke = _smoke()
    windows = smoke.ProfiledWindows(libs=[])
    windows.windows = [_window(smoke, (68, 152), (68, 152), 40_111)]
    assert not windows.agree()

"""cuda_lib.launch runs a kernel on its operands' device (the index that
check_cuda returns) and leaves the caller's current device as it found
it, on the CPU: the C launcher, the device getter and setter and the
stream lookup are stand-ins that record what a launch would see."""

import pytest

from kateth_tpu_torch import cuda_lib


class FakeCuda:
    """One process's current CUDA device, and a launcher that records the
    device current at its call and the stream it was given."""

    def __init__(self, current: int):
        self.current = current
        self.sets = []
        self.calls = []
        self.fail = False

    def get(self) -> int:
        return self.current

    def set(self, index: int) -> None:
        self.sets.append(index)
        self.current = index

    def stream(self, index: int) -> int:
        return 1000 + index

    def launcher(self, *args):
        self.calls.append((self.current, args))
        if self.fail:
            raise OSError("launch")
        return 0


@pytest.fixture
def cuda(monkeypatch):
    fake = FakeCuda(current=0)
    monkeypatch.setattr(cuda_lib, "_get_device", fake.get)
    monkeypatch.setattr(cuda_lib, "_set_device", fake.set)
    monkeypatch.setattr(cuda_lib, "_current_stream", fake.stream)
    monkeypatch.setitem(cuda_lib._LAUNCHERS, "mont_mul", fake.launcher)
    monkeypatch.setitem(cuda_lib.LAUNCHES, "mont_mul", 0)
    return fake


def test_launch_on_another_device_selects_it_and_restores(cuda):
    cuda_lib.launch("mont_mul", 1, 7, 8)
    assert cuda.calls == [(1, (7, 8, 1001))]  # device 1 current, its stream
    assert cuda.current == 0 and cuda.sets == [1, 0]
    assert cuda_lib.LAUNCHES["mont_mul"] == 1


def test_launch_on_the_current_device_sets_nothing(cuda):
    cuda.current = 1
    cuda_lib.launch("mont_mul", 1, 7)
    assert cuda.calls == [(1, (7, 1001))] and cuda.sets == []


def test_failed_launch_restores_the_device(cuda):
    cuda.fail = True
    with pytest.raises(OSError):
        cuda_lib.launch("mont_mul", 2, 7)
    assert cuda.calls[0][0] == 2 and cuda.current == 0
    assert cuda_lib.LAUNCHES["mont_mul"] == 0

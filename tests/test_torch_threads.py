"""One intra-op thread for PyTorch in every process that collects the
port's tests.

pytest imports every test module before it runs any, in each xdist worker
as in a single process, so this import-time setting reaches every port
test. With PyTorch's default (a thread per core) six workers on an
eight-core host run ~50 threads, and the port's CPU tests ran for more
than 25 minutes where they take about a minute on one thread each. Every
port test passes on one thread: none depends on the thread count."""
import torch

torch.set_num_threads(1)


def test_port_tests_run_on_one_intra_op_thread():
    assert torch.get_num_threads() == 1

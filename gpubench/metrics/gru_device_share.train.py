"""The share of the traced train steps' busy device time spent in cuDNN's
RNN (the packed note GRUs of ``use_rnn``, forward and backward): the device
seconds of the kernels whose names match :data:`RNN` over the busy seconds.
It matches cuDNN's own kernels (``elemWiseRNNcell``, ``GRU_elementWise_*``,
``RNN_*``) and the cuBLAS small-N products (``gemmSN_*``) that cuDNN calls
for each time step's hidden product; on an H100 under PyTorch 2.11 and
cuDNN 9.2 a MetricalGNN ``use_rnn`` step launches as many of each as of
``elemWiseRNNcell``, and the HybridGNN and HybridHGT train steps launch
none of them.  Nothing where no such kernel ran."""

import re

RNN = re.compile(r"(?i)rnn|gru|gemmSN_")


def read(summary, traced):
    seconds = sum(s for name, s in summary.kernels if RNN.search(name))
    if seconds <= 0 or summary.busy_s <= 0:
        return None
    return 100.0 * seconds / summary.busy_s

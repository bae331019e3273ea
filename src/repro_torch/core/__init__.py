# The DiOMP runtime core on stacked rank tensors: context.py (DiompContext +
# communicator handles), backends.py (pluggable CclBackend verbs as torch
# ops over the rank dimensions), groups.py, pgas.py, streams.py, rma.py,
# faults.py and resilience.py (fault injection and retries), and the
# paper-verbatim surfaces ompccl.py / ompx.py.

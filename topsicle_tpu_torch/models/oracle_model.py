"""The host model for telophrases past the device k-mer capacity (k > 15).

Re-exports topsicle_tpu/models/oracle_model.py::OracleScanModel, loaded
without the jax-importing `topsicle_tpu.models` package (see _host.py):
numpy in, numpy out, computed with the oracle's semantics.  TorchEngine
swaps it in for such a phrase only, as JaxEngine does.
"""

from topsicle_tpu_torch._host import load

OracleScanModel = load("models/oracle_model.py").OracleScanModel

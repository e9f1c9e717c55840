"""The IVF-PQ index of the port (counterpart of ``semtools_tpu/index``)."""

from semtools_tpu_torch.index.ivf_pq import IvfPqIndex
from semtools_tpu_torch.index.kmeans import kmeans_fit, kmeans_step
from semtools_tpu_torch.index.pq import PQCodebook, adc_scan, adc_tables, pq_encode, pq_fit

__all__ = [
    "kmeans_fit",
    "kmeans_step",
    "PQCodebook",
    "pq_fit",
    "pq_encode",
    "adc_tables",
    "adc_scan",
    "IvfPqIndex",
]

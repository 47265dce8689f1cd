"""The analysis layer: op records of a step (``op_trace``), its roofline
at the H100's peaks (``roofline``), the ops and kernels that take the most
(``top_ops``) and the roofline recomputed from saved records
(``reanalyze``)."""

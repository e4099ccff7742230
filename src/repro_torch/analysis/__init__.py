"""Roofline analysis — the port of ``repro.analysis``: the H100's peaks
(``roofline``), the analytic useful FLOPs (``flops``), each kernel's bytes
and operations per call (``costs``) and the dry run's report
(``report``)."""

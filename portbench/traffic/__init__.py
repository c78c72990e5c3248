"""Traffic: each mix is a data file ``<traffic>.json`` of parameters, read by
the driver module it names (``txt2img``)."""

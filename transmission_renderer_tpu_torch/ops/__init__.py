"""Array operators: culling, binning, the G-buffer raster, texture and
pyramid sampling (counterpart of ``transmission_renderer_tpu/ops``)."""

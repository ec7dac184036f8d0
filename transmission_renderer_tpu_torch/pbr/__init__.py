"""PBR layer: lights, clustering, tonemap, volume attenuation
(counterpart of ``transmission_renderer_tpu/pbr``)."""

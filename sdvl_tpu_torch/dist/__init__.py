"""Distribution layer: device meshes over ``torch.distributed``, point-
sharded bundle adjustment, multi-stream serving (counterpart of
``sdvl_tpu/dist``)."""

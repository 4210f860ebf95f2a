"""The five FROST examples of the JAX package's ``examples/``, on the port:
``python -m repro_torch.examples.<name>``.  Each has ``main(argv=None,
...)``; the device model is ``H100_SXM`` unless the caller hands another
(``device_spec=``)."""

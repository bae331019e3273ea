"""The paper's examples on the port: run each as
``python -m repro_torch.examples.<name>`` (the card by default,
``--device cpu`` on a machine without one)."""

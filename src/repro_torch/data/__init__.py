"""The synthetic data pipeline (the reference's ``repro/data``)."""

"""Placement rules of the model stack (the rest of ``distributed/`` is
still to port: ROADMAP queue 1, item 8)."""

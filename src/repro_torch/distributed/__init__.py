"""Placement rules of the model stack and the pod-aware hierarchical
collectives (the rest of ``distributed/`` is still to port: ROADMAP queue
1, item 8)."""

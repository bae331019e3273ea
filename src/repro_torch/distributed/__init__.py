"""Placement rules of the model stack, the pod-aware hierarchical
collectives, the gradient buckets and the int8 codecs (the dp_only layout
is still to port: ROADMAP queue 1, item 8)."""

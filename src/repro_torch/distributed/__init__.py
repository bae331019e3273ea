"""Placement rules of the model stack (the tp and dp_only layouts), the
pod-aware hierarchical collectives, the gradient buckets and the int8
codecs."""

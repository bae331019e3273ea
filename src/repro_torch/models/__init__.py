"""The model stack, dense family (the other families are still to port:
ROADMAP queue 1, item 9)."""

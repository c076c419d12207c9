"""Adaptation engines: the online prototype adaptation step and its train loop."""

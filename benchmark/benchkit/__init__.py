"""The benchmark's yardstick: its inputs, the plain reference, the counts, the
trace reduction, the comparison that decides `correct`, and the run."""

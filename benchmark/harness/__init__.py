"""The benchmark's harness: the manifest and its files (manifest.py), the
system under test built as the command line builds it (system.py), the
measured window and the run (run_cell.py), the device trace's reduction
(trace.py) and the comparison that decides `correct` (check.py)."""

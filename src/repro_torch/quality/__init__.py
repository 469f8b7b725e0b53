"""Recall-tiered approximate search: stop rules (`stop_rules`) and their
offline calibration (`calibrate`), the counterpart of `repro.quality`."""

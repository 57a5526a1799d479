"""Host-to-tensor conversion of the calibration and the event batches."""

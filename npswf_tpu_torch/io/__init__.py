"""Host I/O: raw segments, their decode, the WF writer and the merge of
its part files."""

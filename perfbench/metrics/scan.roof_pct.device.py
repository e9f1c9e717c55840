"""``scan.roof_pct``, read the same way, in the cells whose end-to-end
reading of the scan is the device's time a query (``search_device_ms``)."""

from pathlib import Path

from perfbench import cells

read = cells.read_of(Path(__file__).resolve().parent.parent, "scan.roof_pct")

"""``search.corpus_gb``, read the same way, in the cells whose end-to-end
reading is the device's time a query (``search_device_ms``): a copy of the
documents' rows is device time a request."""

from pathlib import Path

from perfbench import cells

read = cells.read_of(Path(__file__).resolve().parent.parent, "search.corpus_gb")

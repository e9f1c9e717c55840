"""The program's ``scan`` stage a request: the scan and the copy of its
answers to the host (``.tolist()``), ending in a synchronise."""


def read(r):
    return r.stage_ms_per_request("scan")

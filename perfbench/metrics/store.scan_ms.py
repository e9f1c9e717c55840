
def read(r):
    ms = r.stage_ms_per_request("store_scan")
    return None if ms is None else {"value": ms, "tier": r.tier}

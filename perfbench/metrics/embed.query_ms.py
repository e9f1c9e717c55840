"""The program's ``embed_query`` stage a request: tokenize the query texts
on the host, pool their table rows on the card."""


def read(r):
    return r.stage_ms_per_request("embed_query")

"""Corpus lines embedded a second in set-up: the corpus's lines over the
program's ``embed`` stage (``create_documents_from_contents``)."""


def read(r):
    s = r.setup_stages.get("embed")
    if not s or s[0] <= 0:
        return None
    return r.rows / s[0]

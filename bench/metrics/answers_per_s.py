"""Snapshot answers completed in the window (queries x snapshots) over
the window's seconds, from its start to the end of its last query, less
the time the check's sample took to copy the answers it keeps."""


def read(records):
    queries = records["queries"]
    if not queries or records["window_s"] <= 0:
        return None
    return len(queries) * records["snapshots"] / records["window_s"]

"""Entry points of the port: the serving launcher (`serve.py`) and its
HTTP/SSE frontend (`http.py`), the training launcher (`train.py`) and the
dry run on `meta` (`dryrun.py`)."""

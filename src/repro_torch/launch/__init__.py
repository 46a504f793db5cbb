"""Entry points of the port: the serving launcher (`serve.py`) and its
HTTP/SSE frontend (`http.py`)."""

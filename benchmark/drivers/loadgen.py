"""Open-loop HTTP load: each request is sent at ``start_at + at``
(``time.monotonic``) for every ``at`` before ``seconds``, on a thread of its
own, whether or not earlier ones were answered; then every request sent is
waited for, up to ``wait_s``.  A request's thread connects and encodes its
body half a second ahead, so that it reaches the server on time.  The
standard library only: this process never touches the card.

Reads one JSON object on stdin: ``url``, ``start_at``, ``seconds``,
``wait_s`` and ``requests`` (``[prompt ids, max_tokens, temperature, at]``,
in the order of ``at``).  Writes one JSON object on stdout: ``records``, one
a request sent, ``[index, due, answered or null, status, tokens, completion
id]`` (monotonic seconds).
"""

from __future__ import annotations

import http.client
import json
import sys
import threading
import time
import urllib.parse


def main() -> int:
    job = json.load(sys.stdin)
    reqs, url = job["requests"], job["url"]
    records = []
    lock = threading.Lock()

    where = urllib.parse.urlsplit(url)

    def send(i: int, due: float) -> None:
        prompt, max_tokens, temperature, _ = reqs[i]
        body = json.dumps(dict(prompt=prompt, max_tokens=max_tokens,
                               temperature=temperature)).encode()
        headers = {"Content-Type": "application/json", "Content-Length": str(len(body))}
        try:
            conn = http.client.HTTPConnection(where.hostname, where.port, timeout=job["wait_s"])
            conn.connect()
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            conn.request("POST", where.path, body, headers)
            r = conn.getresponse()
            data = r.read()
            conn.close()
            if r.status == 200:
                out = json.loads(data)
                rec = [i, due, time.monotonic(), 200, out["choices"][0]["tokens"], out["id"]]
            else:
                rec = [i, due, None, r.status, [], None]
        except Exception:  # refused, timed out: never answered
            rec = [i, due, None, 0, [], None]
        with lock:
            records.append(rec)

    threads = []
    for i, (_, _, _, at) in enumerate(reqs):
        if at >= job["seconds"]:
            break
        due = job["start_at"] + at
        delay = due - 0.5 - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        t = threading.Thread(target=send, args=(i, due))
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    json.dump(dict(records=sorted(records)), sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())

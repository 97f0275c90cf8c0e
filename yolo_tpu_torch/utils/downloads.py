"""Weight downloads (the port's copy of ``yolo_tpu/utils/downloads.py``).

``attempt_download`` returns a local file as it is, or fetches it: the
known ultralytics checkpoints from their Google Drive ids, anything else
from pjreddie.com. A result of 1 MB or less is removed and raised on with
the mirror's URL. The Drive flow answers a large file's virus-scan page
with its confirm token in a second request.

``opener`` (a ``urllib`` opener: ``open(url, timeout)``) is injectable, so
the flow runs without a network; a network failure raises the same
``FileNotFoundError`` with the mirror's URL.
"""

from __future__ import annotations

import os
import re
import shutil
import time
import zipfile
from pathlib import Path

# checkpoint name -> Google Drive id
GDRIVE_IDS = {
    'yolov3-spp.weights': '16lYS4bcIdM2HdmyJBVDOvt3Trx6N3W2R',
    'yolov3.weights': '1uTlyDWlnaqXcsKOktP5aH_zRDbfcDp-y',
    'yolov3-tiny.weights': '1CCF-iNIIkYesIDzaPvdwlcf7H9zSsKZQ',
    'yolov3-spp.pt': '1f6Ovy3BSq2wYq4UfvFUpxJFNDFfrIDcR',
    'yolov3.pt': '1SHNFyoe5Ni8DajDNEqgB2oVKBb_NoEad',
    'yolov3-tiny.pt': '10m_3MlpQwRtZetQxtksm9jqHrPTHZ6vo',
    'darknet53.conv.74': '1WUVBid-XuoUBmvzBVUCBl_ELrzqwA8dJ',
    'yolov3-tiny.conv.15': '1Bw0kCpplxUqyRYAJr9RY9SGnOJbo9nEj',
    'yolov3-spp-ultralytics.pt': '1UcR-zVoMs7DH5dj3N1bswkiQTA4dmKF4',
}

KNOWN_WEIGHTS = set(GDRIVE_IDS)

_HELP_URL = 'https://drive.google.com/open?id=1LezFG5g3BCW6iYaV89B2i64cqEUZD7e0'
_CONFIRM_RE = re.compile(r'confirm=([0-9A-Za-z_\-]+)')


def _default_opener():
    """One urllib opener with an in-memory cookie jar."""
    import http.cookiejar
    import urllib.request
    jar = http.cookiejar.CookieJar()
    return urllib.request.build_opener(
        urllib.request.HTTPCookieProcessor(jar))


def _fetch_to(opener, url: str, dest: str, timeout: float = 300.0) -> None:
    with opener.open(url, timeout=timeout) as r, open(dest, 'wb') as f:
        shutil.copyfileobj(r, f)


def gdrive_download(id: str, name: str, opener=None) -> int:
    """Download a (possibly large) Google Drive file; returns 0 on success.
    A large file answers the first request with an HTML virus-scan page
    carrying a confirm token, and the second request sends it back as
    ``confirm=<token>``. Zip archives are unzipped in place and removed."""
    t = time.time()
    print(f'Downloading https://drive.google.com/uc?export=download&id={id} '
          f'as {name}... ', end='', flush=True)
    for p in (name, 'cookie'):
        if os.path.exists(p):
            os.remove(p)
    opener = opener or _default_opener()
    url = f'https://drive.google.com/uc?export=download&id={id}'
    try:
        with opener.open(url, timeout=300.0) as r:
            head = r.read()
        token = None
        m = _CONFIRM_RE.search(head.decode('utf-8', 'replace'))
        ctype = ''
        try:
            ctype = r.headers.get('Content-Type', '')
        except Exception:
            pass
        if m and 'text/html' in ctype:
            token = m.group(1)
        if token:                        # large file: confirmed second GET
            _fetch_to(opener, f'{url}&confirm={token}', name)
        else:                            # small file: first response IS it
            with open(name, 'wb') as f:
                f.write(head)
    except Exception as e:
        if os.path.exists(name):
            os.remove(name)
        print(f'Download error {e}')
        return 1

    if name.endswith('.zip'):
        print('unzipping... ', end='', flush=True)
        with zipfile.ZipFile(name) as z:
            z.extractall(os.path.dirname(name) or '.')
        os.remove(name)
    print(f'Done ({time.time() - t:.1f}s)')
    return 0


def attempt_download(weights: str, opener=None) -> str:
    """A usable local path, downloaded when it is missing: known names
    from Google Drive, everything else from pjreddie.com; a partial or
    undersized (<= 1 MB) result is removed and raised on."""
    weights = str(weights).strip().replace("'", '')
    if not weights or os.path.isfile(weights):
        return weights

    name = Path(weights).name
    msg = (f'{weights} missing, try downloading from {_HELP_URL}'
           if name in GDRIVE_IDS else
           f'{weights} missing, try downloading from '
           f'https://pjreddie.com/media/files/{name}')
    try:
        if name in GDRIVE_IDS:
            r = gdrive_download(GDRIVE_IDS[name], weights, opener=opener)
        else:
            url = f'https://pjreddie.com/media/files/{name}'
            print(f'Downloading {url}')
            _fetch_to(opener or _default_opener(), url, weights)
            r = 0
    except Exception:
        r = 1

    if not (r == 0 and os.path.exists(weights)
            and os.path.getsize(weights) > 1e6):
        if os.path.exists(weights):
            os.remove(weights)           # remove partial download
        raise FileNotFoundError(msg)
    return weights

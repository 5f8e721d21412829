"""A minimal .xlsx writer without dependencies.

Counterpart of ``acoustic_image_generation_tpu/utils/xlsx.py``: the
reference's 5-seed aggregation writes an Excel workbook (its ``meanstd.py``,
through pandas/openpyxl); the format is a zip of XML parts, so this writes
SpreadsheetML directly: one worksheet, inline strings for text cells, plain
numbers for numerics, byte for byte what the JAX package writes.
"""

from __future__ import annotations

import numbers
import zipfile
from xml.sax.saxutils import escape

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets><sheet name="{name}" sheetId="1" r:id="rId1"/></sheets>
</workbook>"""

_WORKBOOK_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
</Relationships>"""


def _col_name(i: int) -> str:
    name = ""
    i += 1
    while i:
        i, rem = divmod(i - 1, 26)
        name = chr(ord("A") + rem) + name
    return name


def _cell(row: int, col: int, value) -> str:
    ref = f"{_col_name(col)}{row + 1}"
    # numbers.Real catches numpy scalars too (np.float64 reprs as
    # "np.float64(...)" under numpy>=2, which corrupts the sheet, and
    # np.int64/np.float32 would otherwise become text cells)
    if isinstance(value, numbers.Real) and not isinstance(value, bool):
        v = int(value) if isinstance(value, numbers.Integral) else float(value)
        return f'<c r="{ref}"><v>{v!r}</v></c>'
    text = escape(str(value))
    return f'<c r="{ref}" t="inlineStr"><is><t>{text}</t></is></c>'


def write_xlsx(path: str, rows: list[list], *, sheet_name: str = "Sheet1") -> str:
    """Write ``rows`` (lists of str/int/float cells) as a one-sheet xlsx."""
    body = "".join(
        f'<row r="{r + 1}">' + "".join(_cell(r, c, v) for c, v in enumerate(row)) + "</row>"
        for r, row in enumerate(rows)
    )
    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
        f"<sheetData>{body}</sheetData></worksheet>"
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK.format(name=escape(sheet_name)))
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
    return path


def read_xlsx_rows(path: str) -> list[list]:
    """Parse back a sheet written by ``write_xlsx`` (tests / debugging)."""
    import re
    import xml.etree.ElementTree as ET

    ns = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main"}
    with zipfile.ZipFile(path) as z:
        sheet = z.read("xl/worksheets/sheet1.xml").decode()
    root = ET.fromstring(sheet)
    rows = []
    for row in root.findall(".//m:row", ns):
        cells = []
        for c in row.findall("m:c", ns):
            if c.get("t") == "inlineStr":
                cells.append(c.find("m:is/m:t", ns).text or "")
            else:
                v = c.find("m:v", ns).text
                cells.append(float(v) if re.search(r"[.e]", v) else int(v))
        rows.append(cells)
    return rows

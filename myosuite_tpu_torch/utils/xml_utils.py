"""MJCF XML manipulation: merge models, reparent subtrees (the JAX
package's `utils/xml_utils.py`).

Role-equivalent of the reference's xml_utils
(MyoSuite's myosuite/utils/xml_utils.py:73,105): combine two MJCF
files (asset/tendon/actuator/worldbody sections merged) and graft a body
subtree under a new parent. Operates on ElementTree, preserving structure;
use mjcf.editor.ModelEditor for MjSpec-level (compiled) surgery.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

_MERGE_SECTIONS = ("asset", "tendon", "actuator", "sensor", "contact",
                   "equality", "default")


def parse_xml(xml: str) -> ET.Element:
  return ET.fromstring(xml)


def to_string(root: ET.Element) -> str:
  ET.indent(root)
  return ET.tostring(root, encoding="unicode")


def merge_xmls(base_xml: str, other_xml: str) -> str:
  """Merge `other_xml`'s sections and worldbody children into base
  (reference merge_xmls semantics)."""
  base = parse_xml(base_xml)
  other = parse_xml(other_xml)

  for tag in _MERGE_SECTIONS + ("worldbody",):
    src = other.find(tag)
    if src is None:
      continue
    dst = base.find(tag)
    if dst is None:
      dst = ET.SubElement(base, tag)
    for child in list(src):
      dst.append(child)
  return to_string(base)


def find_body(root: ET.Element, name: str):
  for body in root.iter("body"):
    if body.get("name") == name:
      return body
  return None


def _find_parent(root: ET.Element, target: ET.Element):
  for parent in root.iter():
    if target in list(parent):
      return parent
  return None


def reparent_body(xml: str, body_name: str, new_parent_name: str,
                  pos: str = None) -> str:
  """Move body `body_name` (with its whole subtree) under
  `new_parent_name` (reference reparent semantics)."""
  root = parse_xml(xml)
  body = find_body(root, body_name)
  assert body is not None, body_name
  old_parent = _find_parent(root, body)
  new_parent = (root.find("worldbody") if new_parent_name == "worldbody"
                else find_body(root, new_parent_name))
  assert new_parent is not None, new_parent_name
  old_parent.remove(body)
  if pos is not None:
    body.set("pos", pos)
  new_parent.append(body)
  return to_string(root)


def remove_body(xml: str, body_name: str) -> str:
  """Delete a body subtree (tendons/actuators referencing it must be
  cleaned by the caller or via ModelEditor, which resolves references)."""
  root = parse_xml(xml)
  body = find_body(root, body_name)
  assert body is not None, body_name
  _find_parent(root, body).remove(body)
  return to_string(root)
